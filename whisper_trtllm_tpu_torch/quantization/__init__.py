"""Load-time weight quantization (counterpart of
``whisper_trtllm_tpu/quantization``, the weight-only int8 subset)."""

from whisper_trtllm_tpu_torch.quantization.quantize import (  # noqa: F401
    dequantize_kernel,
    dequantize_params,
    quantize_dense_params,
    quantize_embedding,
    quantize_kernel,
    quantize_vocab_embedding,
    weight_only_quantize,
)
