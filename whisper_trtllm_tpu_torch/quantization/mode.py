"""Quantization mode flags (counterpart of
``whisper_trtllm_tpu/quantization/mode.py``: the same ``IntFlag`` values
and predicates)."""

from __future__ import annotations

import enum


class QuantMode(enum.IntFlag):
    NONE = 0
    INT8_WEIGHTS = enum.auto()      # weight-only int8 (per-channel scales)
    INT4_WEIGHTS = enum.auto()      # weight-only int4 (packed nibbles)
    INT8_KV_CACHE = enum.auto()     # int8 KV cache (per-token scales)
    SMOOTH_QUANT = enum.auto()      # int8 act x int8 weight, smoothed
    FP8_QDQ = enum.auto()           # fp8 weight storage + activation QDQ
    FP8_KV_CACHE = enum.auto()      # float8_e4m3fn KV cache (per-token scales)

    def has_int8_weights(self) -> bool:
        return bool(self & QuantMode.INT8_WEIGHTS)

    def has_int8_kv_cache(self) -> bool:
        return bool(self & QuantMode.INT8_KV_CACHE)

    def has_fp8_qdq(self) -> bool:
        return bool(self & QuantMode.FP8_QDQ)

    def has_fp8_kv_cache(self) -> bool:
        return bool(self & QuantMode.FP8_KV_CACHE)

    def has_kv_cache_quant(self) -> bool:
        return bool(self & (QuantMode.INT8_KV_CACHE | QuantMode.FP8_KV_CACHE))

    def has_act_and_weight_quant(self) -> bool:
        """SmoothQuant: int8 activations with per-token dynamic scales and
        int8 weights with per-channel scales."""
        return bool(self & QuantMode.SMOOTH_QUANT)

    @classmethod
    def use_weight_only(cls, use_int4: bool = False) -> "QuantMode":
        return cls.INT4_WEIGHTS if use_int4 else cls.INT8_WEIGHTS

    @classmethod
    def use_smooth_quant(cls) -> "QuantMode":
        return cls.SMOOTH_QUANT
