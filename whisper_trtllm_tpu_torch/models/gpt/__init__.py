from whisper_trtllm_tpu_torch.models.gpt.model import (  # noqa: F401
    GPTConfig,
    convert_hf_gpt2,
    forward,
    generate,
    generate_beam,
    generate_ptuning,
    generate_ragged,
    init_params,
)
