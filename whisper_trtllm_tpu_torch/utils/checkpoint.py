"""Checkpoint loading and saving: ``config.json`` + flax
``params.msgpack``, read and written with plain ``msgpack`` (counterpart of
``whisper_trtllm_tpu/utils/checkpoint.py``).

flax serializes each array as a msgpack extension of type 1 whose payload
is itself msgpack: ``(shape, dtype_name, raw_bytes)``, C order. Nested
dicts keep the JAX parameter tree's keys; kernels are ``(in, out)`` with a
stacked leading layer axis, which is also the port's layout.

numpy names ``"bfloat16"`` only once ``ml_dtypes`` is imported, which the
port never does: a bfloat16 payload is read as raw 2-byte words into a
``torch.bfloat16`` tensor, and a bfloat16 tensor is written as such a
payload with the same bits, as flax writes it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import msgpack
import numpy as np
import torch

from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.utils.device import resolve_device, to_numpy

_EXT_NDARRAY = 1
_CHUNKED_MARKER = "__msgpack_chunked_array__"
# flax splits an array above this many bytes into chunks
_MAX_CHUNK_BYTES = 2 ** 30


_BF16 = "bfloat16"


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        shape, dtype_name, buf = msgpack.unpackb(data)
        if dtype_name == _BF16:
            # bytearray: a writable copy, which torch.frombuffer wants
            words = (torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
                     if buf else torch.empty(0, dtype=torch.bfloat16))
            return words.reshape(shape)
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
    raise ValueError(f"unsupported msgpack extension type {code}")


def _ext_pack(x):
    """The writer's side of ``_ext_hook``: an ndarray, or a bfloat16
    tensor's 2-byte words, as extension 1."""
    if isinstance(x, np.ndarray):
        payload = (x.shape, x.dtype.name, x.tobytes("C"))
    elif isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        payload = (tuple(x.shape), _BF16,
                   x.view(torch.int16).numpy().tobytes("C"))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")
    return msgpack.ExtType(_EXT_NDARRAY,
                           msgpack.packb(payload, use_bin_type=True))


def _check_tree(tree, path="") -> None:
    if isinstance(tree, dict):
        if _CHUNKED_MARKER in tree:
            raise NotImplementedError(
                f"chunked array at {path or '/'} (arrays over 1 GiB) is not "
                "supported")
        for k, v in tree.items():
            _check_tree(v, f"{path}/{k}")


def read_msgpack(path: str) -> dict:
    """flax ``params.msgpack`` → nested dict of numpy arrays (bfloat16
    leaves: ``torch.bfloat16`` tensors)."""
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)
    _check_tree(tree)
    return tree


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.element_size() > 1


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """The weight carry: a JAX-package parameter tree (numpy arrays, or
    anything ``np.asarray`` takes) → the port's tree of tensors on
    ``device``, same keys, same ``(in, out)`` kernel layout.

    ``dtype`` casts floating leaves wider than one byte, like
    ``models.whisper.model.cast_params``; int8 kernels and tables stay int8.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        # np.array copies: frombuffer arrays are read-only, torch wants
        # writable memory
        t = torch.from_numpy(np.array(tree))
    t = t.to(device)
    if dtype is not None and _is_float(t):
        t = t.to(dtype)
    return t


def load_checkpoint(path: str, device=None,
                    dtype: Optional[torch.dtype] = None
                    ) -> Tuple[dict, WhisperConfig]:
    """``<path>/params.msgpack`` + ``<path>/config.json`` → (tensor tree on
    ``device``, config). ``device`` defaults to the CUDA card."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = WhisperConfig.from_json(f.read())
    tree = read_msgpack(os.path.join(path, "params.msgpack"))
    return params_from_numpy(tree, dev, dtype), cfg


def _host_tree(tree, path=""):
    """Tensors → C-ordered numpy, bfloat16 tensors → contiguous CPU
    bfloat16 tensors; dict keys sorted as flax writes them."""
    if isinstance(tree, dict):
        return {k: _host_tree(tree[k], f"{path}/{k}") for k in sorted(tree)}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        arr = tree.detach().cpu().contiguous()
        nbytes = arr.numel() * arr.element_size()
    else:
        arr = np.ascontiguousarray(to_numpy(tree))
        nbytes = arr.nbytes
    if nbytes > _MAX_CHUNK_BYTES:
        raise NotImplementedError(
            f"array at {path} exceeds 1 GiB: flax would write it chunked, "
            "which is not supported")
    return arr


def save_checkpoint(path: str, params: dict, cfg: WhisperConfig) -> None:
    """Write ``<path>/params.msgpack`` (flax msgpack, byte for byte what
    ``flax.serialization.msgpack_serialize`` writes for the same arrays)
    and ``<path>/config.json``; both ``load_checkpoint``s read them."""
    os.makedirs(path, exist_ok=True)
    packed = msgpack.packb(_host_tree(params), default=_ext_pack,
                           strict_types=True)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(packed)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())
