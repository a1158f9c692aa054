"""Worked examples of the port (counterparts of the repository's
``examples/``), run as ``python -m whisper_trtllm_tpu_torch.examples.<...>``."""
