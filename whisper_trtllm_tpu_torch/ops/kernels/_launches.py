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
import gc
import threading

import torch

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


def capture(step, kernels: dict):
    """Capture ``step()`` (already warmed up) into a new CUDA graph:
    (the graph, {name: launches one replay makes} over ``kernels``, the
    wrappers by name). The launches this thread records are taken back,
    since a capture launches nothing; ``replayed`` adds them for each
    replay. Another thread's launches meanwhile stay counted and are not
    the graph's. No garbage collection runs while the stream captures: a
    collection that frees another graph (its weights were garbage in a
    cycle) destroys it, which a capture does not permit."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        # "thread_local": other threads may keep using the card while this
        # one captures (a server's frontend calls); this thread's own host
        # syncs still fail the capture
        with recording() as recorded, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            step()
    finally:
        if collecting:
            gc.enable()
        for fn, n in recorded.items():
            count(fn, -n)
    return graph, {name: recorded[fn] for name, fn in kernels.items()
                   if recorded.get(fn)}


def replayed(launches: dict, kernels: dict) -> None:
    """Count one replay of a graph that ``capture`` returned ``launches``
    for."""
    for name, n in launches.items():
        count(kernels[name], n)
