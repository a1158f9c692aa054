"""Typed configuration for models, generation and runtime.

The port's own copy of ``whisper_trtllm_tpu/config.py``: the same frozen
dataclasses (``MeshConfig`` included), fields, defaults, presets and
JSON round-trip, so a
``config.json`` written by either package loads in the other. The port
imports nothing from the JAX package, so it keeps this copy. Fields whose
behaviour the port does not implement yet are refused where they are read
(``runtime/session.py``, ``runtime/generation.py``), never ignored.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union


def _freeze(x):
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


@dataclass(frozen=True)
class WhisperConfig:
    """Whisper model hyperparameters.

    Field names and defaults mirror the HF schema that is the reference's
    source of truth (reference: transformers/src/transformers/models/whisper/
    configuration_whisper.py:196-235; consumed via config.pkl in
    examples/whisper/build_encoder.py:42-45).
    """

    vocab_size: int = 51864
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation_function: str = "gelu"
    # token ids / generation-relevant config (from HF config / generation config)
    decoder_start_token_id: int = 50257
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    bos_token_id: int = 50257
    suppress_tokens: Tuple[int, ...] = ()
    begin_suppress_tokens: Tuple[int, ...] = (220, 50256)
    # ((position, token_id), ...) — forced prefix, e.g. ((1, 50362),) for .en
    # "no timestamps" (reference: examples/whisper/run.py:161-165)
    forced_decoder_ids: Tuple[Tuple[int, int], ...] = ()
    # timestamp decoding (multilingual / large): <|notimestamps|> id; the
    # timestamp vocabulary starts at no_timestamps_token_id + 1
    no_timestamps_token_id: Optional[int] = None
    max_initial_timestamp_index: Optional[int] = 50

    def __post_init__(self):
        object.__setattr__(self, "suppress_tokens", _freeze(self.suppress_tokens))
        object.__setattr__(
            self, "begin_suppress_tokens", _freeze(self.begin_suppress_tokens)
        )
        object.__setattr__(self, "forced_decoder_ids", _freeze(self.forced_decoder_ids))

    # -- derived ------------------------------------------------------------
    @property
    def encoder_head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def decoder_head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_hf(cls, hf_config: Any, generation_config: Any = None) -> "WhisperConfig":
        """Build from a transformers ``WhisperConfig`` (and optionally its
        ``GenerationConfig`` for forced/suppress ids)."""
        d = hf_config.to_dict()
        kw = {}
        for f_ in dataclasses.fields(cls):
            if f_.name in d and d[f_.name] is not None:
                kw[f_.name] = _freeze(d[f_.name])
        gc = generation_config
        if gc is not None:
            for name in ("suppress_tokens", "begin_suppress_tokens", "forced_decoder_ids"):
                v = getattr(gc, name, None)
                if v is not None:
                    kw[name] = _freeze(v)
            for name in (
                "decoder_start_token_id", "eos_token_id", "pad_token_id",
                "bos_token_id", "no_timestamps_token_id",
                "max_initial_timestamp_index",
            ):
                v = getattr(gc, name, None)
                if v is not None:
                    kw[name] = v
        return cls(**kw)

    @classmethod
    def tiny_en(cls) -> "WhisperConfig":
        return cls(
            vocab_size=51864, d_model=384,
            encoder_layers=4, encoder_attention_heads=6,
            decoder_layers=4, decoder_attention_heads=6,
            encoder_ffn_dim=1536, decoder_ffn_dim=1536,
            forced_decoder_ids=((1, 50362),), no_timestamps_token_id=50362,
        )

    @classmethod
    def base_en(cls) -> "WhisperConfig":
        return cls(
            vocab_size=51864, d_model=512,
            encoder_layers=6, encoder_attention_heads=8,
            decoder_layers=6, decoder_attention_heads=8,
            encoder_ffn_dim=2048, decoder_ffn_dim=2048,
            forced_decoder_ids=((1, 50362),), no_timestamps_token_id=50362,
        )

    @classmethod
    def small_en(cls) -> "WhisperConfig":
        return cls(
            vocab_size=51864, d_model=768,
            encoder_layers=12, encoder_attention_heads=12,
            decoder_layers=12, decoder_attention_heads=12,
            encoder_ffn_dim=3072, decoder_ffn_dim=3072,
            forced_decoder_ids=((1, 50362),), no_timestamps_token_id=50362,
        )

    @classmethod
    def medium_en(cls) -> "WhisperConfig":
        return cls(
            vocab_size=51864, d_model=1024,
            encoder_layers=24, encoder_attention_heads=16,
            decoder_layers=24, decoder_attention_heads=16,
            encoder_ffn_dim=4096, decoder_ffn_dim=4096,
            forced_decoder_ids=((1, 50362),), no_timestamps_token_id=50362,
        )

    @classmethod
    def large_v3(cls) -> "WhisperConfig":
        return cls(
            vocab_size=51866, num_mel_bins=128, d_model=1280,
            encoder_layers=32, encoder_attention_heads=20,
            decoder_layers=32, decoder_attention_heads=20,
            encoder_ffn_dim=5120, decoder_ffn_dim=5120,
            decoder_start_token_id=50258, eos_token_id=50257,
            pad_token_id=50257, bos_token_id=50257,
            no_timestamps_token_id=50364,
        )

    @classmethod
    def preset(cls, name: str) -> "WhisperConfig":
        name = name.replace("whisper-", "").replace(".", "_").replace("-", "_")
        fn = getattr(cls, name, None)
        if fn is None:
            raise ValueError(f"unknown Whisper preset: {name}")
        return fn()

    # tiny shapes for unit tests (the reference's tiny-config pattern,
    # reference: tests/model/test_gpt.py:47)
    @classmethod
    def testing(cls, **overrides) -> "WhisperConfig":
        kw = dict(
            vocab_size=97, num_mel_bins=16, d_model=32,
            encoder_layers=2, encoder_attention_heads=4,
            decoder_layers=2, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_source_positions=24, max_target_positions=16,
            decoder_start_token_id=1, eos_token_id=2, pad_token_id=2,
            bos_token_id=1,
            suppress_tokens=(5, 7), begin_suppress_tokens=(3,),
            forced_decoder_ids=((1, 11),),
        )
        kw.update(overrides)
        return cls(**kw)

    # -- JSON round-trip ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "WhisperConfig":
        return cls(**{k: _freeze(v) for k, v in json.loads(s).items()})


@dataclass(frozen=True)
class GenerationConfig:
    """Sampling/search configuration (analog of SamplingConfig,
    reference: tensorrt_llm/runtime/generation.py:120-138)."""

    max_new_tokens: int = 96
    num_beams: int = 1
    length_penalty: float = 1.0
    temperature: float = 1.0
    top_k: int = 0          # 0 → greedy/beam (no sampling)
    top_p: float = 0.0      # 0 → disabled
    # True / False / "never" — the three HF early-stopping modes for beam
    # search (False and "never" keep searching while a running beam could
    # still beat the worst finished hypothesis)
    early_stopping: Union[bool, str] = True
    # timestamp decoding (requires cfg.no_timestamps_token_id; the forced
    # prefix must not pin <|notimestamps|>)
    return_timestamps: bool = False
    repetition_penalty: float = 1.0
    seed: int = 0           # PRNG seed for sampling
    # "auto" follows the compute dtype; "int8"/"fp8" store self+cross KV
    # caches quantized with per-token scales (QuantMode.INT8_KV_CACHE /
    # FP8_KV_CACHE analogs; fp8 = float8_e4m3fn storage)
    kv_cache_dtype: str = "auto"
    # cross-attention cache layout: "bhtd" (head_dim minor, the natural
    # projection layout) or "bhdt" (encoder-T minor — fills full 128-lane
    # HBM tiles, 2.38x faster cross-reads at medium dims on v5e, see
    # models/whisper/model.py::transpose_cross_kv). "auto" = bhdt for
    # quantized caches (where the full-cache read dominates step traffic
    # and the win is measured), bhtd for float (keeps the fused-step and
    # Pallas ablation paths intact).
    cross_kv_layout: str = "auto"
    # word-rule / length processors (the reference DynamicDecodeLayer's
    # presence_penalty / min_length / bad_words_list / stop_words_list
    # inputs, cpp/tensorrt_llm/layers/dynamicDecodeLayer.h:37-128), applied
    # inside the Whisper decode loops like every other processor
    presence_penalty: float = 0.0
    min_new_tokens: int = 0
    # token-id sequences: ban the final token when the trailing context
    # matches the prefix / end decoding when the full sequence matches
    bad_words: Tuple[Tuple[int, ...], ...] = ()
    stop_words: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "bad_words", _freeze(self.bad_words))
        object.__setattr__(self, "stop_words", _freeze(self.stop_words))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "GenerationConfig":
        return cls(**json.loads(s))


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution-mode flags (analog of PluginConfig + BuilderConfig precision
    flags, reference: tensorrt_llm/plugin/plugin.py:33-140,
    tensorrt_llm/builder.py:70-142)."""

    compute_dtype: str = "float32"     # "float32" | "bfloat16"
    # "native" keeps checkpoint precision; "int8"/"int4" apply per-channel
    # weight-only quantization to all dense projections at session load
    # (quantization.weight_only_quantize*); "fp8" stores dense kernels
    # float8_e4m3fn with per-tensor scales and QDQs activations through fp8
    # (quantization.fp8_quantize — the reference's QuantMode.FP8_QDQ)
    weight_dtype: str = "native"
    # int8-quantize the tied vocab table (quantization.quantize_embedding):
    # the vocab-head einsum reads the table int8 (largest single per-step
    # weight read: 40 MB bf16 at tiny.en, 106 MB at medium.en), per-row
    # scales applied after the dot
    quantize_vocab: bool = False
    # fuse self-attention q/k/v into one matmul at load. Measured neutral
    # within run-to-run noise on v5e (docs/PERFORMANCE.md); kept for parity
    # with the reference's fused layout and for TP granularity. Off by
    # default to keep compiled-graph caches stable across configs.
    fuse_qkv: bool = False
    # fp32 QK^T + softmax even under bf16 compute — mirrors the reference's
    # forced-fp32 attention core (reference:
    # tensorrt_llm/models/whisper/model.py:292-295)
    fp32_attention_softmax: bool = True
    fp32_logits: bool = True
    use_pallas: Optional[bool] = None  # None → auto (TPU backend only)
    donate_caches: bool = True
    persistent_cache_dir: Optional[str] = None  # JAX compilation cache

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RuntimeConfig":
        return cls(**json.loads(s))


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``data`` ranks split the batch, ``model`` ranks
    split the attention heads and the MLP's columns (``parallel/``)."""

    data: int = 1    # data-parallel axis size (utterance batches)
    model: int = 1   # tensor-parallel axis size (heads / ffn shards)

    @property
    def world_size(self) -> int:
        return self.data * self.model

    def axis_names(self) -> Tuple[str, str]:
        return ("data", "model")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "MeshConfig":
        return cls(**json.loads(s))
