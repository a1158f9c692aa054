from whisper_trtllm_tpu_torch.models.bert.model import (  # noqa: F401
    BertConfig,
    convert_hf_bert,
    forward,
    init_params,
)
