"""The kernel wrappers' launch counts.

A wrapper calls ``count(wrapper)`` where it launches its kernel, and
nowhere else; the count is the wrapper's ``launches`` attribute. While a
thread records a CUDA graph inside ``recording()``, its own launches are
also tallied for it, so that the capture takes back exactly the launches
it recorded: a launch that another thread makes meanwhile (a server's
frontend) is real and stays counted.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_local = threading.local()


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper.launches``, and to this thread's
    tally while it records."""
    with _lock:
        wrapper.launches += n
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + n


@contextlib.contextmanager
def recording():
    """Tally this thread's launches while the block runs: yields the tally,
    {wrapper: launches}."""
    tally = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None
