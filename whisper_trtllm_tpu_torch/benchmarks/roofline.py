"""Analytic FLOP and byte counts and the card's peaks, for MFU and the
decode roofline (counterpart of the JAX package's
``benchmarks/roofline.py``; the port keeps its own copy, with the same
counting conventions, over its own ``WhisperConfig``).

Counting conventions (standard MFU accounting):
  * matmul (m,k)x(k,n) = 2*m*k*n FLOPs;
  * attention scores + weighted sum both counted (4*S*d per query vector);
  * elementwise/LN/softmax FLOPs ignored (<<1% at these shapes);
  * bytes = minimum device-memory reads of weights + KV caches per decode
    step; activations at decode are (B, 1, d) and round to nothing.
"""

from __future__ import annotations

from whisper_trtllm_tpu_torch.config import WhisperConfig

# dense bf16 peak TFLOP/s and device-memory GB/s of a card, keyed by
# torch.cuda.get_device_name(); NVIDIA's H100 SXM data sheet (dense, no
# sparsity, at the full 700 W power limit)
CHIP_PEAKS = {
    # name: (peak_bf16_tflops, hbm_gbps)
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}


def chip_peaks(device_name: str):
    """(peak_bf16_tflops, hbm_gbps) for a ``torch.cuda.get_device_name()``,
    or (None, None) when unknown (MFU is then reported as null rather than
    guessed)."""
    for k, v in CHIP_PEAKS.items():
        if device_name.lower().startswith(k.lower()):
            return v
    return (None, None)


def encoder_flops(cfg: WhisperConfig) -> float:
    """FLOPs for one 30 s utterance through the encoder (conv stem +
    transformer stack), batch 1."""
    d = cfg.d_model
    s_in = 2 * cfg.max_source_positions      # 3000 mel frames
    s = cfg.max_source_positions             # 1500 after stride-2 conv
    mels = cfg.num_mel_bins
    # conv1: (s_in, mels) * k3 -> d ; conv2: stride 2, (s, d) * k3 -> d
    conv = 2 * s_in * mels * 3 * d + 2 * s * d * 3 * d
    per_layer = (
        4 * 2 * s * d * d                     # q,k,v,out projections
        + 2 * 2 * s * s * d                   # scores + weighted sum
        + 2 * 2 * s * d * cfg.encoder_ffn_dim # MLP in+out
    )
    return float(conv + cfg.encoder_layers * per_layer)


def cross_kv_flops(cfg: WhisperConfig) -> float:
    """One-time cross K/V projection of the encoder states (computed once
    per utterance, before the decode loop)."""
    s, d = cfg.max_source_positions, cfg.d_model
    return float(cfg.decoder_layers * 2 * 2 * s * d * d)


def decode_step_flops(cfg: WhisperConfig, step_index: int) -> float:
    """FLOPs for ONE decode step of ONE sequence at self-cache length
    ``step_index`` (0-based)."""
    d = cfg.d_model
    s = cfg.max_source_positions
    l = cfg.decoder_layers
    per_layer = (
        4 * 2 * d * d              # self q,k,v,out
        + 2 * 2 * d * d            # cross q + out (k/v precomputed)
        + 2 * 2 * (step_index + 1) * d   # self scores + weighted sum
        + 2 * 2 * s * d            # cross scores + weighted sum
        + 2 * 2 * d * cfg.decoder_ffn_dim
    )
    return float(l * per_layer + 2 * d * cfg.vocab_size)  # + vocab head


def decode_flops(cfg: WhisperConfig, gen_tokens: int) -> float:
    """FLOPs for a full greedy decode of one sequence (gen_tokens steps)."""
    return sum(decode_step_flops(cfg, i) for i in range(gen_tokens))


def pipeline_flops_per_utt(cfg: WhisperConfig, gen_tokens: int) -> float:
    """Total model FLOPs for one utterance end to end (frontend excluded:
    the STFT product is ~0.3% of the encoder)."""
    return encoder_flops(cfg) + cross_kv_flops(cfg) + decode_flops(
        cfg, gen_tokens)


def decoder_weight_bytes(cfg: WhisperConfig, weight_bytes: float = 2.0,
                         vocab_bytes: float = 2.0) -> float:
    """Bytes of decoder weights read once per decode step (weights dominate
    decode traffic at small batch): per layer 6 d^2 projections + 2 d*ffn
    MLP, plus the tied vocab table."""
    d, l = cfg.d_model, cfg.decoder_layers
    per_layer = 6 * d * d + 2 * d * cfg.decoder_ffn_dim
    return float(l * per_layer * weight_bytes
                 + d * cfg.vocab_size * vocab_bytes)


def decode_bytes_per_step(cfg: WhisperConfig, batch: int, cache_len: int,
                          weight_bytes: float = 2.0,
                          kv_bytes: float = 2.0,
                          vocab_bytes: float = 2.0,
                          kv_scale_bytes: float = 0.0) -> float:
    """Minimum device-memory bytes for ONE decode step of a ``batch`` at
    self-cache length ``cache_len``: weights once (shared across the
    batch) + per-row self-KV reads up to cache_len + full cross-KV reads.

    ``kv_scale_bytes``: bytes per (token, head) of dequantization scale
    read beside quantized KV (the int8/fp8 cache is a 4-tuple kq/ks/vq/vs
    with fp32 scales of shape (B, H, T, 1), ``ops/attention.py::
    quantize_kv``); pass 4.0 for quantized caches, 0.0 (default) for float
    caches. At dh=64 int8 this is a 4/64 correction the floor would
    otherwise understate."""
    d, l = cfg.d_model, cfg.decoder_layers
    h = cfg.decoder_attention_heads
    s = cfg.max_source_positions
    self_kv = 2 * cache_len * (d * kv_bytes + h * kv_scale_bytes)
    cross_kv = 2 * s * (d * kv_bytes + h * kv_scale_bytes)
    return float(decoder_weight_bytes(cfg, weight_bytes, vocab_bytes)
                 + batch * l * (self_kv + cross_kv))
