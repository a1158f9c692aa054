"""Device selection and float32 numerics for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Asking for CUDA where there is none raises; nothing
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def set_fp32_precision() -> None:
    """Full float32 for matrix products and convolutions on the card.

    cuBLAS already defaults to full fp32, but cuDNN runs fp32 convolutions
    in TF32 unless told otherwise, and TF32 keeps about three decimal
    digits: the conv stem would drift from the reference. Both flags are
    process-wide; the session entry points set them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_numpy(x) -> np.ndarray:
    """A numpy array from a tensor on any device or anything ``np.asarray``
    takes; bfloat16 tensors widen to float32 (exact), since numpy has no
    bfloat16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or anything ``np.array`` takes
    (numpy, lists, read-only buffers, JAX arrays); numpy input is copied,
    so the caller's buffer is never aliased."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)
