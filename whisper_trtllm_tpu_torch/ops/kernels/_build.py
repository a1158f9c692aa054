"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<digest>.so`` at the repository root (a
directory ``.gitignore`` lists), for ``sm_90a``. The digest covers the
source and the flags, so an edited source never loads a stale library.
Shared headers (``csrc/*.cuh``) count in every source's digest.
``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``.log``.

A file with a C interface builds in seconds, where one that includes
PyTorch's headers takes minutes, so nothing here includes them: pointers
and the stream cross as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Raises with the compiler's
    output if any fails."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name, out in todo:
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use, with
    ``argtypes`` set from ``signatures`` (every launch function returns
    an ``int`` cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def needs_grad(*tensors) -> bool:
    """True when autograd is recording and one of ``tensors`` (None
    skipped) requires grad: the call must then go through a
    ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel with no backward would be handed an input that
    requires grad: its output (filled through ctypes) would carry no
    ``grad_fn`` and cut the graph without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: an input requires grad and this kernel has no "
            "backward; call it under torch.no_grad() or through the "
            "differentiable entry point")


def aligned16(*tensors) -> bool:
    """Every given tensor (None skipped) starts on a 16-byte boundary: a
    kernel may then move it as 16-byte vectors."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function
    (a refused launch never runs, and no later synchronize reports it)."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")
