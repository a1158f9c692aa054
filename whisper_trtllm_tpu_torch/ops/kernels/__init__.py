"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterparts of ``whisper_trtllm_tpu/ops/pallas``):

- ``flash_attention.flash_fwd`` — K1, encoder self-attention and, in
  training, the cross attention (≙ ``flash_attention.py::flash_mha``,
  forward), with an optional log-sum-exp output;
- ``flash_attention.flash_bwd`` — K4, its backward (≙ ``_bwd_impl``),
  joined to K1 by the autograd ``FlashAttention`` (≙ the custom VJP);
- ``decode_attention.decode_attn`` — K2, the decode step's self and cross
  attention, float or int8/fp8 caches, dh- or T-minor
  (≙ ``decode_attention.py::decode_mha`` and ``attention.py::
  mha_decode_step``);
- ``stft.stft_log_mel`` — K3, the log-mel frontend
  (≙ ``stft.py::stft_log_mel``);
- ``layer_norm.layer_norm`` — K5, every LayerNorm of the model
  (≙ ``layer_norm.py::layer_norm_fused``), differentiable through the
  autograd ``LayerNorm`` (a plain-op backward);
- ``fused_decoder_step.fused_decoder_layer_step`` — K6, a decoder layer's
  decode step after the cache append, one launch, on the float-weight path
  (≙ ``fused_decoder_step.py::fused_decoder_layer_step``);
- ``cross_attention.cross_decode_mha`` — K7, one token's cross attention
  against a head-contiguous ``(B, T, H·dh)`` cache, a library kernel that
  the hardware check (``cli/gpu_check.py``) runs
  (≙ ``cross_attention.py::cross_decode_mha``).

K8, the worked example's ``fused_bias_gelu``, lives with its example in
``examples/custom_kernel``.

A wrapper takes its plain version only for CPU tensors; for a CUDA tensor
it launches its kernel or raises, and it refuses an input that requires
grad where autograd records (its output would cut the graph). Sources live in ``csrc/`` and build at
first use (``_build``).
"""

from whisper_trtllm_tpu_torch.ops.kernels.cross_attention import (  # noqa: F401
    cross_decode_mha,
    cross_decode_mha_reference,
)
from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (  # noqa: F401
    decode_attention_reference,
    decode_attn,
)
from whisper_trtllm_tpu_torch.ops.kernels.flash_attention import (  # noqa: F401
    FlashAttention,
    attention_lse_reference,
    attention_reference,
    flash_attention,
    flash_attention_backward_reference,
    flash_bwd,
    flash_fwd,
)
from whisper_trtllm_tpu_torch.ops.kernels.fused_decoder_step import (  # noqa: F401
    fused_decoder_layer_step,
    fused_decoder_layer_step_reference,
    fused_layer_supported,
)
from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import (  # noqa: F401
    LayerNorm,
    layer_norm,
    layer_norm_backward,
    layer_norm_reference,
)
from whisper_trtllm_tpu_torch.ops.kernels.stft import (  # noqa: F401
    stft_log_mel,
    stft_log_mel_reference,
)

KERNELS = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
           "decode_attn": decode_attn,
           "stft_log_mel": stft_log_mel, "layer_norm": layer_norm,
           "fused_decoder_layer_step": fused_decoder_layer_step,
           "cross_decode_mha": cross_decode_mha}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
