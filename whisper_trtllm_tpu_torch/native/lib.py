"""ctypes bindings for the native runtime library (counterpart of
``whisper_trtllm_tpu/native/lib.py``, which has no JAX; the port keeps its
own copy). The C++ sources are the repository's ``cpp/``: a plain C ABI,
no torch in the serving path.

``build_native`` compiles ``cpp/src/*.cc`` with ``g++ -std=c++17 -O2
-shared -fPIC`` into ``build/native/libwtpu-<digest>.so`` at the
repository root (a directory ``.gitignore`` lists) at first use. The
digest covers the sources, the headers under ``cpp/include`` and the
flags, so an edited source never loads a stale library. No cmake or ninja
is needed: ``g++`` alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
CPP_DIR = _REPO_ROOT / "cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _sources() -> list:
    return sorted((CPP_DIR / "src").glob("*.cc"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _sources() + sorted((CPP_DIR / "include").rglob("*.h")):
        h.update(p.relative_to(CPP_DIR).as_posix().encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libwtpu-{h.hexdigest()[:16]}.so"


def build_native(verbose: bool = False) -> str:
    """Build libwtpu.so with ``g++`` unless an up-to-date one exists;
    returns its path. Raises with the compiler's output if it fails."""
    out = library_path()
    if out.exists():
        return str(out)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    cmd = [cxx, *CXX_FLAGS, "-I", str(CPP_DIR / "include"),
           *map(str, _sources()), "-o", str(tmp), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if verbose or proc.returncode != 0:
        print(proc.stdout + proc.stderr)
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    finally:
        if tmp.exists():
            tmp.unlink()
    return str(out)


def load_library(auto_build: bool = True) -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_native() if auto_build else str(library_path())
        lib = ctypes.CDLL(path)

        lib.wtpu_load_wav16k.restype = ctypes.c_int64
        lib.wtpu_load_wav16k.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.wtpu_slot_manager_new.restype = ctypes.c_void_p
        lib.wtpu_slot_manager_new.argtypes = [ctypes.c_int]
        lib.wtpu_slot_manager_free.argtypes = [ctypes.c_void_p]
        lib.wtpu_submit.restype = ctypes.c_int64
        lib.wtpu_submit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.wtpu_schedule.restype = ctypes.c_int
        lib.wtpu_schedule.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.wtpu_complete.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.wtpu_fetch.restype = ctypes.c_int64
        lib.wtpu_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.wtpu_pending.restype = ctypes.c_int64
        lib.wtpu_pending.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_library(auto_build=True)
        return True
    except Exception:
        return False


def load_wav_16k(data: bytes, max_seconds: float = 120.0) -> np.ndarray:
    """Decode a WAV blob to 16 kHz mono float32 via the native decoder."""
    lib = load_library()
    capacity = int(max_seconds * 16000)
    out = np.empty(capacity, np.float32)
    n = lib.wtpu_load_wav16k(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity,
    )
    if n < 0:
        raise ValueError("malformed WAV data")
    return out[:n].copy()


class NativeSlotManager:
    """Python handle on the C++ SlotManager (request queue + batch slots)."""

    def __init__(self, num_slots: int, max_samples: int = 480000):
        self._lib = load_library()
        self._ptr = self._lib.wtpu_slot_manager_new(num_slots)
        self.num_slots = num_slots
        self.max_samples = max_samples

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.wtpu_slot_manager_free(self._ptr)
            self._ptr = None

    def submit(self, audio: np.ndarray) -> int:
        audio = np.ascontiguousarray(audio, np.float32)
        return self._lib.wtpu_submit(
            self._ptr,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(audio),
        )

    def schedule(self):
        """Returns (request_ids (S,), audio batch (S, max_samples), active)."""
        ids = np.empty(self.num_slots, np.int64)
        audio = np.empty((self.num_slots, self.max_samples), np.float32)
        active = self._lib.wtpu_schedule(
            self._ptr,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.max_samples,
        )
        return ids, audio, active

    def complete(self, slot: int, tokens: np.ndarray) -> None:
        tokens = np.ascontiguousarray(tokens, np.int32)
        self._lib.wtpu_complete(
            self._ptr, slot,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tokens),
        )

    def fetch(self, request_id: int, capacity: int = 512):
        tokens = np.empty(capacity, np.int32)
        n = self._lib.wtpu_fetch(
            self._ptr, request_id,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), capacity,
        )
        if n < 0:
            return None
        return tokens[:n].copy()

    @property
    def pending(self) -> int:
        return self._lib.wtpu_pending(self._ptr)


class NativeBatchScheduler:
    """Python handle on the C++ BatchScheduler — the batch-forming policy of
    the reference's batch manager (reference:
    cpp/tensorrt_llm/batch_manager/trtGptModelInflightBatching.h request
    pickup): priority queue + allowed-batch-size launch policy + tail-latency
    guard + deadline expiry, all under a native mutex so any number of
    ingest threads can Submit while one scheduler thread Polls."""

    def __init__(self, allowed_batch_sizes, max_wait_ms: int = 20):
        self._lib = load_library()
        sizes = np.ascontiguousarray(sorted(allowed_batch_sizes), np.int32)
        self._lib.wtpu_scheduler_new.restype = ctypes.c_void_p
        self._lib.wtpu_scheduler_pending.restype = ctypes.c_int64
        self._free = self._lib.wtpu_scheduler_free
        self._ptr = self._lib.wtpu_scheduler_new(
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(sizes), ctypes.c_int64(max_wait_ms))
        self._max_batch = int(sizes[-1])

    def __del__(self):
        try:
            if getattr(self, "_ptr", None):
                self._free(ctypes.c_void_p(self._ptr))
                self._ptr = None
        except (TypeError, AttributeError):
            # interpreter teardown: ctypes globals may already be gone
            pass

    def submit(self, request_id: int, priority: int = 0,
               timeout_ms: int = 0) -> None:
        self._lib.wtpu_scheduler_submit(
            ctypes.c_void_p(self._ptr), ctypes.c_int64(request_id),
            ctypes.c_int(priority), ctypes.c_int64(timeout_ms))

    def poll(self):
        """Returns (batch ids ndarray, expired ids ndarray) — batch is empty
        when the policy says wait. The expired buffer is sized to the whole
        queue: everything droppable this round fits, nothing leaks."""
        batch = np.empty(self._max_batch, np.int64)
        cap = max(int(self.pending), 16)
        expired = np.empty(cap, np.int64)
        n_expired = ctypes.c_int64(0)
        n = self._lib.wtpu_scheduler_poll(
            ctypes.c_void_p(self._ptr),
            batch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._max_batch,
            expired.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
            ctypes.byref(n_expired))
        return batch[:n].copy(), expired[: n_expired.value].copy()

    def flush(self):
        """Drain the queue as a list of batches, each at most the largest
        allowed size (every batch maps to a pre-compiled shape)."""
        batches = []
        buf = np.empty(self._max_batch, np.int64)
        while True:
            n = self._lib.wtpu_scheduler_flush(
                ctypes.c_void_p(self._ptr),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._max_batch)
            if n == 0:
                return batches
            batches.append(buf[:n].copy())

    @property
    def pending(self) -> int:
        return self._lib.wtpu_scheduler_pending(ctypes.c_void_p(self._ptr))

    def stats(self) -> dict:
        out = np.zeros(6, np.int64)
        self._lib.wtpu_scheduler_stats(
            ctypes.c_void_p(self._ptr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return {
            "submitted": int(out[0]), "launched_batches": int(out[1]),
            "launched_requests": int(out[2]), "expired": int(out[3]),
            "queue_delay_p50_us": int(out[4]),
            "queue_delay_p95_us": int(out[5]),
        }
