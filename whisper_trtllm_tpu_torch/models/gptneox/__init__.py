from whisper_trtllm_tpu_torch.models.gptneox.model import (  # noqa: F401
    GPTNeoXConfig,
    apply_partial_rope,
    convert_hf_gptneox,
    forward,
    generate,
    generate_beam,
    generate_ragged,
    init_params,
    neox_rope_sin_cos,
)
