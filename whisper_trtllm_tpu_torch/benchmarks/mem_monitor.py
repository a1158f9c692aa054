"""Peak device memory of a benchmark region (counterpart of the JAX
package's ``benchmarks/mem_monitor.py``, same API).

The source of truth is PyTorch's caching allocator on the card
(``torch.cuda.memory_stats``), which keeps its own peak since the last
``reset_peak_memory_stats``: no sampling thread is needed. The numbers are
the bytes of tensors allocated, not the allocator's reserved pool.

On the CPU there are no such statistics, and every reading is -1.0, as
the JAX module reports on a backend without them.
"""

from __future__ import annotations

import torch

_GIB = 1024.0 ** 3


def _cuda(device) -> torch.device | None:
    """The card ``device`` names (default: the current card), or None on
    the CPU or without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev


def get_memory_info(device=None):
    """(total_gib, used_gib, peak_gib) of ``device`` (default: the current
    card): the card's size, the bytes allocated now and their peak since
    the last reset; (-1.0, -1.0, -1.0) on the CPU."""
    dev = _cuda(device)
    if dev is None:
        return -1.0, -1.0, -1.0
    stats = torch.cuda.memory_stats(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    used = stats.get("allocated_bytes.all.current", 0)
    peak = stats.get("allocated_bytes.all.peak", 0)
    return (round(total / _GIB, 2), round(used / _GIB, 2),
            round(peak / _GIB, 2))


class MemoryMonitor:
    """Peak device memory over a benchmark region.

    >>> mon = MemoryMonitor().start()
    >>> ...   # timed benchmark work
    >>> peak_gib = mon.stop()

    ``start`` resets the allocator's peak, so the reading covers the
    region (weights already resident included); ``stop`` reads it, and a
    second ``stop`` returns the same reading.
    """

    def __init__(self, device=None):
        self.device = _cuda(device)
        self.peak_gib = -1.0
        self._running = False

    def start(self) -> "MemoryMonitor":
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._running = True
        return self

    def stop(self) -> float:
        """The peak GiB allocated since ``start`` (-1.0 on the CPU)."""
        if self._running and self.device is not None:
            torch.cuda.synchronize(self.device)
            self.peak_gib = get_memory_info(self.device)[2]
        self._running = False
        return self.peak_gib
