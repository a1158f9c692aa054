"""Command-line entry points of the port, run as
``python -m whisper_trtllm_tpu_torch.cli.<name>`` (counterparts of the
repository's ``cli/``)."""
