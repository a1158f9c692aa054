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

A tree cut over a mesh (``parallel/partition.py``) goes to a sharded
checkpoint (``save_sharded``/``load_sharded``) in the format of
``torch.distributed.checkpoint`` (DCP: a directory of ``.distcp`` files
and a ``.metadata``), where the JAX package writes orbax's: each rank writes
its shards, and a loader reads only the slices its own shards need.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
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


def init_compilation_cache(cache_dir: str) -> None:
    """Build and find the kernels' libraries under ``cache_dir`` for the
    rest of the process (``ops/kernels/_build.py``'s ``BUILD_DIR``), the
    counterpart of the JAX function that points XLA's persistent
    compilation cache there. The directory is made if missing. A library
    already loaded stays loaded: its digest names the same code. A process
    that finds every library there runs no ``nvcc``."""
    from whisper_trtllm_tpu_torch.ops.kernels import _build

    path = Path(cache_dir).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path


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


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def save_sharded(path: str, params: dict,
                 cfg: Optional[WhisperConfig] = None) -> None:
    """Write ``params`` as a DCP checkpoint in the directory ``path``, each
    leaf under its dotted path. On a tree that ``shard_params`` cut, every
    rank of its mesh calls this and writes its own shards: each leaf goes
    in as a ``DTensor`` whose placements say which shards are whose (a
    plain tensor would stand for the whole leaf, replicated, and one rank's
    shard would be written as if it were all of it). A leaf cut over the
    model axis is stored with its cut dim split into (groups, units, unit)
    (``Cut.view``), so that DCP's even chunks of the units are the cut by
    whole heads. A tree without a layout is written whole and needs
    ``cfg`` for the head counts of that split."""
    from torch.distributed.checkpoint import save
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from whisper_trtllm_tpu_torch.parallel import partition

    layout = partition.layout_of(params)
    if layout is None:
        if cfg is None:
            raise ValueError("save_sharded: a tree that shard_params did not "
                             "cut needs cfg (its attention projections are "
                             "stored by heads)")
        cuts = partition.tree_cuts(params, cfg)
    else:
        cuts = layout.cuts
    state = {}
    for p, leaf in partition.leaves(params):
        t, whole = leaf.detach(), tuple(leaf.shape)
        cut = cuts.get(p)
        if cut is not None:
            n = (cut.count if layout is None else partition.chunk_range(
                cut.count, layout.tp, layout.rank)[1])
            t, whole = t.reshape(cut.view(t.shape, n)), cut.view(t.shape)
        if layout is not None:
            t = DTensor.from_local(
                t, layout.mesh, [Replicate(), Shard(cut.dim + 1)
                                 if cut is not None else Replicate()],
                run_check=False, shape=torch.Size(whole),
                stride=_contiguous_stride(whole))
        state[".".join(p)] = t
    save(state, checkpoint_id=path)


def load_sharded(path: str, shardings=None, device=None) -> dict:
    """Read a ``save_sharded`` checkpoint. With ``shardings`` (a mesh of
    ``parallel.make_mesh``) every rank of it calls this and gets its own
    shards, cut as ``shard_params`` cuts them, read straight into them (no
    whole tree is formed) on the mesh's device, with their layout recorded;
    the mesh may differ from the one that wrote the checkpoint. Without, the
    whole tree on ``device`` (the CUDA card by default)."""
    from torch.distributed.checkpoint import FileSystemReader, load
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from whisper_trtllm_tpu_torch.parallel import partition

    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    skeleton: dict = {}
    for key, m in meta.items():
        partition.set_path(skeleton, tuple(key.split(".")), m)
    layout = None if shardings is None else partition.make_layout(
        shardings, {})
    dev = (torch.device(shardings.device_type) if shardings is not None
           else resolve_device(device))
    state, shapes = {}, {}
    for p, m, spec in partition.leaves_with_specs(
            skeleton, partition.default_specs(skeleton)):
        vshape, dtype = tuple(m.size), m.properties.dtype
        key, cut, n = ".".join(p), None, None
        shape = vshape
        if "model" in spec:
            dim = spec.index("model")
            shape = (vshape[:dim] + (math.prod(vshape[dim:dim + 3]),)
                     + vshape[dim + 3:])
            cut = partition.leaf_cut(p, shape, spec, {p[0]: vshape[dim + 1]},
                                     1 if layout is None else layout.tp)
        if layout is None:
            state[key] = torch.empty(vshape, dtype=dtype, device=dev)
        elif cut is None:
            state[key] = DTensor.from_local(
                torch.empty(vshape, dtype=dtype, device=dev), shardings,
                [Replicate(), Replicate()], run_check=False)
        else:
            layout.cuts[p] = cut
            n = partition.chunk_range(cut.count, layout.tp, layout.rank)[1]
            state[key] = DTensor.from_local(
                torch.empty(cut.view(shape, n), dtype=dtype, device=dev),
                shardings, [Replicate(), Shard(cut.dim + 1)],
                run_check=False, shape=torch.Size(vshape),
                stride=_contiguous_stride(vshape))
        shapes[key] = (p, shape, cut, n)
    load(state, checkpoint_id=path)
    tree: dict = {}
    for key, (p, shape, cut, n) in shapes.items():
        t = state[key]
        if isinstance(t, DTensor):
            t = t.to_local()
        if cut is not None:
            n = cut.count if n is None else n
            t = t.reshape(shape[:cut.dim] + (cut.groups * n * cut.unit,)
                          + shape[cut.dim + 1:])
        partition.set_path(tree, p, t)
    return tree if layout is None else partition.record(tree, layout)
