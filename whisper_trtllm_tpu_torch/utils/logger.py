"""The port's logger, its severity set by ``WHISPER_TPU_LOG_LEVEL``, the
JAX package's variable (counterpart of
``whisper_trtllm_tpu/utils/logger.py``), under the name
``whisper_trtllm_tpu_torch``."""

from __future__ import annotations

import logging
import os

_LEVELS = {
    "verbose": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "internal_error": logging.CRITICAL,
}


def _make_logger() -> logging.Logger:
    lg = logging.getLogger("whisper_trtllm_tpu_torch")
    if not lg.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s] [WT-TORCH] [%(levelname)s] "
                              "%(message)s"))
        lg.addHandler(h)
    level = os.environ.get("WHISPER_TPU_LOG_LEVEL", "warning").lower()
    lg.setLevel(_LEVELS.get(level, logging.WARNING))
    lg.propagate = False
    return lg


logger = _make_logger()
