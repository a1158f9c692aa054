from whisper_trtllm_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from whisper_trtllm_tpu_torch.utils.device import (  # noqa: F401
    resolve_device,
    set_fp32_precision,
)
