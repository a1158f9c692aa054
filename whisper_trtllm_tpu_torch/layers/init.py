"""Parameter constructors (counterpart of
``whisper_trtllm_tpu/layers/init.py``).

numpy, drawn from an ``np.random.Generator`` in the JAX package's order, so
one seed gives the same arrays bit for bit in both packages. Parameters are
plain arrays in nested dicts, initialized as HF Whisper is (normal std 0.02,
zero biases), so random-init comparisons against HF torch models hold.
"""

from __future__ import annotations

import numpy as np


def init_dense(rng: np.random.Generator, d_in: int, d_out: int,
               bias: bool = True, std: float = 0.02) -> dict:
    p = {"kernel": rng.normal(0.0, std, (d_in, d_out)).astype(np.float32)}
    if bias:
        p["bias"] = np.zeros((d_out,), np.float32)
    return p


def init_layer_norm(d: int) -> dict:
    return {"scale": np.ones((d,), np.float32),
            "bias": np.zeros((d,), np.float32)}


def init_embedding(rng: np.random.Generator, vocab: int, d: int,
                   std: float = 0.02) -> np.ndarray:
    return rng.normal(0.0, std, (vocab, d)).astype(np.float32)


def init_conv1d(rng: np.random.Generator, k: int, c_in: int, c_out: int,
                std: float = 0.02) -> dict:
    return {
        "kernel": rng.normal(0.0, std, (k, c_in, c_out)).astype(np.float32),
        "bias": np.zeros((c_out,), np.float32),
    }


def init_attention(rng: np.random.Generator, d: int,
                   std: float = 0.02) -> dict:
    """q/k/v/out projections; k has no bias, as in Whisper."""
    return {
        "q": init_dense(rng, d, d, bias=True, std=std),
        "k": init_dense(rng, d, d, bias=False, std=std),
        "v": init_dense(rng, d, d, bias=True, std=std),
        "out": init_dense(rng, d, d, bias=True, std=std),
    }
