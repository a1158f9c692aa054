from whisper_trtllm_tpu_torch.models.chatglm6b.model import (  # noqa: F401
    ChatGLM6BConfig,
    apply_2d_rope,
    build_position_ids,
    convert_hf_chatglm6b,
    forward,
    generate,
    generate_beam,
    generate_ragged,
    glm_rope_tables,
    init_params,
)
