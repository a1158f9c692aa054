from whisper_trtllm_tpu_torch.models.bloom.model import (  # noqa: F401
    BloomConfig,
    convert_hf_bloom,
    forward,
    generate,
    generate_beam,
    generate_ragged,
    init_params,
    step_bias,
)
