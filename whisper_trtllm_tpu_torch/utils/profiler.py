"""Tag-based wall-clock timer and a ``torch.profiler`` trace helper
(counterpart of ``whisper_trtllm_tpu/utils/profiler.py``: ``Timer`` is a
copy; ``profile_trace`` traces with ``torch.profiler`` where the JAX
package traces with ``jax.profiler``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    def __init__(self):
        self._start: Dict[str, float] = {}
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def start(self, tag: str) -> None:
        self._start[tag] = time.perf_counter()

    def stop(self, tag: str) -> float:
        elapsed = time.perf_counter() - self._start.pop(tag)
        self._total[tag] += elapsed
        self._count[tag] += 1
        return elapsed

    @contextlib.contextmanager
    def time(self, tag: str) -> Iterator[None]:
        self.start(tag)
        try:
            yield
        finally:
            self.stop(tag)

    def elapsed(self, tag: str) -> float:
        return self._total[tag]

    def reset(self, tag: Optional[str] = None) -> None:
        if tag is None:
            self._total.clear()
            self._count.clear()
            self._start.clear()
        else:
            self._total.pop(tag, None)
            self._count.pop(tag, None)

    def summary(self) -> str:
        lines = ["Profile results:"]
        for tag, total in sorted(self._total.items()):
            n = self._count[tag]
            lines.append(
                f"  {tag}: total {total*1e3:.2f} ms over {n} calls "
                f"(mean {total/max(n,1)*1e3:.2f} ms)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the CPU, and the CUDA card
    where there is one) and write a Chrome trace, ``trace.json``, under
    ``log_dir`` (made if missing). Nothing is written if the block
    raises."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
