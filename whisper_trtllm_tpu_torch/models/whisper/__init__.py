from whisper_trtllm_tpu_torch.models.whisper.model import (  # noqa: F401
    cast_params,
    compute_cross_kv,
    decode_step_kv,
    encode,
    init_self_kv,
)
