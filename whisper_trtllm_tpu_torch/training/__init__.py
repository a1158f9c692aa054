from whisper_trtllm_tpu_torch.training.train import (  # noqa: F401
    AdamW,
    cross_entropy_loss,
    guided_attn_weights,
    loss_and_grads,
    make_train_step,
    warmup_cosine_decay_schedule,
)
