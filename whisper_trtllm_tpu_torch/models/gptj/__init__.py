from whisper_trtllm_tpu_torch.models.gptj.model import (  # noqa: F401
    GPTJConfig,
    apply_rope_interleaved,
    convert_hf_gptj,
    forward,
    generate,
    generate_beam,
    generate_ragged,
    init_params,
    rope_interleaved_sin_cos,
)
