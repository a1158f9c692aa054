"""Load-time weight quantization (counterpart of
``whisper_trtllm_tpu/quantization``: weight-only int8 and int4, fp8 QDQ,
SmoothQuant for Whisper, the int8 vocab table; the GPT half of
SmoothQuant belongs with the causal-LM models, which the port has not)."""

from whisper_trtllm_tpu_torch.quantization.mode import QuantMode  # noqa: F401
from whisper_trtllm_tpu_torch.quantization.quantize import (  # noqa: F401
    dequantize_kernel,
    dequantize_params,
    fp8_qdq_activation,
    fp8_quantize,
    quantize_dense_params,
    quantize_dense_params_fp8,
    quantize_dense_params_int4,
    quantize_embedding,
    quantize_kernel,
    quantize_kernel_fp8,
    quantize_kernel_int4,
    quantize_vocab_embedding,
    unpack_int4_kernel,
    weight_only_quantize,
    weight_only_quantize_int4,
)
from whisper_trtllm_tpu_torch.quantization.smooth import (  # noqa: F401
    smooth_quantize_whisper,
    whisper_act_stats,
)
