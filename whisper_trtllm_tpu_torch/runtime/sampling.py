"""Token selection (counterpart of ``whisper_trtllm_tpu/runtime/sampling.py``).

Only the greedy branch of ``sample_token`` is ported: with every sampling
knob neutral it is an argmax. Temperature, top-k, top-p and repetition
penalty are later slices and raise.
"""

from __future__ import annotations

import torch


def sample_token(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits → (B,) int32 token ids. ``torch.argmax`` returns the
    first index of the maximum, as ``jnp.argmax`` does on ties."""
    if (temperature != 1.0 or top_k > 0
            or 0.0 < top_p < 1.0 or repetition_penalty != 1.0):
        raise NotImplementedError(
            "only greedy selection is ported: temperature, top_k, top_p "
            "and repetition_penalty must be neutral")
    return torch.argmax(logits, dim=-1).to(torch.int32)
