from whisper_trtllm_tpu_torch.audio.features import (  # noqa: F401
    HOP_LENGTH,
    N_FFT,
    N_SAMPLES,
    SAMPLE_RATE,
    LogMelSpectrogram,
    log_mel_spectrogram,
    pad_or_trim,
    read_wav,
)
from whisper_trtllm_tpu_torch.audio.mel import mel_filter_bank  # noqa: F401
