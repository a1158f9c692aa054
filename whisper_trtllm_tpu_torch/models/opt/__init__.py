from whisper_trtllm_tpu_torch.models.opt.model import (  # noqa: F401
    OPTConfig,
    convert_hf_opt,
    forward,
    generate,
    generate_beam,
    generate_ragged,
    init_params,
)
