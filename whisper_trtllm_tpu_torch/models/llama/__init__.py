from whisper_trtllm_tpu_torch.models.llama.model import (  # noqa: F401
    LlamaConfig,
    apply_rope,
    convert_hf_llama,
    forward,
    generate,
    generate_beam,
    generate_ragged,
    init_params,
    rope_sin_cos,
)
