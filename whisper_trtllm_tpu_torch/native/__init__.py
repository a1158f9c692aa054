"""The native runtime pieces (``cpp/``: the WAV decoder, the request slot
manager and the batch scheduler) through ``ctypes``."""

from whisper_trtllm_tpu_torch.native.lib import (  # noqa: F401
    NativeBatchScheduler,
    NativeSlotManager,
    build_native,
    load_library,
    load_wav_16k,
    native_available,
)
