"""whisper_trtllm_tpu_torch — the PyTorch/CUDA port of ``whisper_trtllm_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``audio``, ``ops``, ``layers``, ``models.whisper``,
``quantization``, ``runtime``, ``utils``) so each function has an obvious
counterpart. Plain tensor code is
PyTorch; each Pallas kernel on the ported path is a CUDA C++ kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/kernels``).

Entry points (``WhisperSession``, ``transcribe_tokens``,
``load_checkpoint``) run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version. Importing the package builds nothing and imports no JAX.
"""

__version__ = "0.1.0"

from whisper_trtllm_tpu_torch.config import (  # noqa: F401
    GenerationConfig,
    RuntimeConfig,
    WhisperConfig,
)
