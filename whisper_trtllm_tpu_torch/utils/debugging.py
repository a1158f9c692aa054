"""Debug support: per-layer intermediate capture and checked execution
(counterpart of ``whisper_trtllm_tpu/utils/debugging.py``).

``encode_with_intermediates`` is ``models.whisper.encode`` that also keeps
each layer's output, the per-module differential-debugging hook.
``checked`` is the counterpart of checkify's NaN check: it runs a function
under a ``TorchDispatchMode`` that raises on the first operator whose
floating output holds a NaN. A kernel launched through ``ctypes`` is not
seen by the dispatcher, so a NaN that a kernel writes surfaces at the first
operator that reads it, or at ``fn``'s outputs, which are checked too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.ops.functional import conv1d, gelu, layer_norm
from whisper_trtllm_tpu_torch.utils.device import to_tensor


def encode_with_intermediates(
    params: dict, cfg: WhisperConfig, mel
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like ``models.whisper.encode`` (the same layers: K1 and K5 on the
    card) but also returns the conv stem's output ``conv_stem`` (B, S, d)
    and each layer's output ``layer_outputs`` (L, B, S, d). ``mel`` (B,
    3000, n_mels), a tensor or numpy, is taken to the weights' device and
    dtype."""
    enc = params["encoder"]
    kernel = enc["conv1"]["kernel"]
    mel = to_tensor(mel, kernel.device, kernel.dtype)
    with torch.no_grad():
        x = gelu(conv1d(enc["conv1"], mel, stride=1, padding=1))
        x = gelu(conv1d(enc["conv2"], x, stride=2, padding=1))
        conv_out = x
        x = x + enc["embed_positions"].to(x.dtype)[None]
        outs = []
        for i in range(cfg.encoder_layers):
            x = wmodel._encoder_layer(wmodel.layer(enc["layers"], i), x,
                                      cfg.encoder_attention_heads)
            outs.append(x)
        final = layer_norm(enc["layer_norm"], x)
    return final, {"conv_stem": conv_out, "layer_outputs": torch.stack(outs)}


# operators that return memory nothing has written yet (a kernel's output
# buffer): its bits are not a result
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "empty_permuted"})


def _has_nan(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point()
               and bool(torch.isnan(t).any())
               for t in pytree.tree_leaves(tree))


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNWRITTEN and _has_nan(out):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


def checked(fn):
    """Wrap ``fn`` so that a NaN made by any operator it runs, or in its
    outputs, raises ``FloatingPointError`` instead of flowing on (the
    graph-assert analog). Each check reads a flag on the host: a debugging
    tool, not a serving path."""

    def wrapper(*args, **kwargs):
        with _NanCheck():
            out = fn(*args, **kwargs)
        if _has_nan(out):
            raise FloatingPointError("NaN in the outputs")
        return out

    return wrapper
