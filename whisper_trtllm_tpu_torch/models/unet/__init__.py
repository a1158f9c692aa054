from whisper_trtllm_tpu_torch.models.unet.model import (  # noqa: F401
    UNetConfig,
    convert_diffusers_unet,
    forward,
    init_params,
    timestep_embedding,
)
