from whisper_trtllm_tpu_torch.models.whisper.model import (  # noqa: F401
    cast_params,
    compute_cross_kv,
    cross_kv_t_major,
    decode_chunk,
    decode_full,
    decode_step,
    decode_step_kv,
    decode_step_ragged,
    decode_step_ragged_kv,
    encode,
    init_params,
    init_self_kv,
    init_self_kv_int8,
    init_self_kv_quant,
    quantize_cross_kv,
    transpose_cross_kv,
)
from whisper_trtllm_tpu_torch.models.whisper.convert import (  # noqa: F401
    convert_hf_model,
    convert_state_dict,
    export_state_dict,
    load_pretrained,
)
