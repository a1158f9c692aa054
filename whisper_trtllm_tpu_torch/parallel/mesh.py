"""The device mesh over ``torch.distributed`` (counterpart of
``whisper_trtllm_tpu/parallel/mesh.py``).

A 2-D ``DeviceMesh`` named ("data", "model"), ``model`` the minor axis:
rank ``d * model + m`` holds data slice ``d`` and model shard ``m``, the
order in which the JAX package lays its devices out. The process group is
NCCL on the card and gloo only when the caller asks for the CPU; nothing
switches one for the other. The collectives that XLA inserts in the JAX
package are written out in ``parallel/collectives.py`` and issued by the
model code itself.

The mesh is a context manager, like JAX's ``with mesh:``: a tree that
``parallel/partition.py::shard_params`` cut over the model axis runs only
inside its own mesh, where the model reads the model axis's group; the
entry points (``runtime/generation.py::transcribe_tokens``, the session,
the train step) cut the batch over the active mesh's data axis.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from whisper_trtllm_tpu_torch.config import MeshConfig
from whisper_trtllm_tpu_torch.parallel.collectives import gather_data
from whisper_trtllm_tpu_torch.utils.device import resolve_device

AXES = ("data", "model")
_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "meshes"):
        _local.meshes = []
    return _local.meshes


class Mesh(DeviceMesh):
    """A ("data", "model") ``DeviceMesh`` that is also this thread's active
    mesh inside ``with``."""

    def __enter__(self):
        _stack().append(self)
        super().__enter__()
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return super().__exit__(*exc)


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh this thread entered, or None."""
    meshes = _stack()
    return meshes[-1] if meshes else None


def check_mesh(mesh) -> None:
    """Refuse a ``mesh`` argument that is neither None nor a ("data",
    "model") ``DeviceMesh`` (``make_mesh``)."""
    if mesh is not None and not (isinstance(mesh, DeviceMesh)
                                 and mesh.mesh_dim_names == AXES):
        raise TypeError(f"mesh must be a (data, model) mesh of "
                        f"parallel.make_mesh, got {type(mesh).__name__}")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``, or None when
    the axis has one rank: no collective is issued over an axis of size 1,
    as XLA issues none."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def split_batch(x, mesh: Optional[DeviceMesh]):
    """This rank's rows of the batch ``x`` (dim 0) over ``mesh``'s data
    axis (all of them without a mesh or at one data rank). A batch the
    data axis does not divide raises, as JAX's ``device_put`` does."""
    if mesh is None or axis_size(mesh, "data") == 1:
        return x
    n = axis_size(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over a "
                         f"data axis of {n} ranks")
    rows = x.shape[0] // n
    start = axis_rank(mesh, "data") * rows
    return x[start:start + rows]


def join_batch(x: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """The whole batch from every data rank's rows (``split_batch``'s
    inverse), on every rank."""
    if mesh is None:
        return x
    return gather_data(x, axis_group(mesh, "data"))


def _backend(device: torch.device) -> str:
    return "gloo" if device.type == "cpu" else "nccl"


def initialize_distributed(device=None, **kwargs) -> None:
    """``torch.distributed.init_process_group`` with the backend of
    ``device`` (the CUDA card by default: NCCL; ``device="cpu"``: gloo).
    Under ``torchrun`` the rank, the world size and the store come from the
    environment (``env://``); otherwise pass ``init_method`` (a
    ``tcp://localhost:PORT`` address or a ``file://`` store), ``world_size``
    and ``rank``, and ``timeout`` where a hang must end. On the card the
    process takes the card of its local rank (``LOCAL_RANK``, else its rank,
    modulo the cards it sees)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=_backend(dev), **kwargs)


def make_mesh(mesh_cfg: Optional[MeshConfig] = None, device=None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (global ranks; every rank
    of the world by default), ``model`` minor. With ``mesh_cfg=None`` every
    rank goes to ``data`` (pure data parallelism). ``device`` (the CUDA card
    by default) must match the process group's backend: a CUDA mesh needs
    NCCL and a CPU mesh gloo. Every rank of the world calls it, also those
    outside ``devices``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.initialize_distributed first")
    backend = dist.get_backend()
    if backend != _backend(dev):
        raise RuntimeError(f"a {dev.type} mesh needs the {_backend(dev)} "
                           f"backend; the process group runs {backend}")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    cfg = mesh_cfg or MeshConfig(data=len(ranks), model=1)
    if cfg.world_size != len(ranks):
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs "
                         f"{cfg.world_size} devices, got {len(ranks)}")
    return Mesh(dev.type, torch.tensor(ranks).reshape(cfg.data, cfg.model),
                mesh_dim_names=AXES)


def check_devices(mesh: Optional[Mesh] = None) -> dict:
    """Startup health check: all-reduce a one from every rank of the mesh
    (over ``data``, then over ``model``, whatever their sizes: the check
    exercises the communicators) and compare with the mesh's size. Returns
    ``{"devices": n, "ok": bool}``. The default mesh is ``make_mesh()``."""
    mesh = mesh or make_mesh()
    n = mesh.size()
    x = torch.ones(1, dtype=torch.float32, device=mesh.device_type)
    for axis in AXES:
        dist.all_reduce(x, group=mesh.get_group(axis))
    return {"devices": n, "ok": abs(float(x.item()) - n) < 1e-6}
