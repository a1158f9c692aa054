"""PyTorch port: bfloat16 checkpoints, both ways.

- A bfloat16 tree written by the JAX package (flax msgpack) loads in the
  port as ``torch.bfloat16`` tensors with the same bits, also in a process
  where ``jax``, ``flax`` and ``ml_dtypes`` cannot be imported (the card's
  host has none of them; numpy knows "bfloat16" only through
  ``ml_dtypes``).
- A bfloat16 tree saved by the port is byte for byte what
  ``flax.serialization.msgpack_serialize`` writes for it, and the JAX
  package's loader reads it back as bfloat16.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import cast_params
from whisper_trtllm_tpu.models.whisper import init_params as jax_init_params
from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jax_load
from whisper_trtllm_tpu.utils.checkpoint import save_checkpoint as jax_save
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(tree, prefix=""):
    """path → (dtype name, the raw 16- or 32-bit words) for every leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_bits(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return {prefix: ("bfloat16", tree.view(torch.int16).numpy())}
        tree = tree.numpy()
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return {prefix: ("bfloat16", arr.view(np.int16))}
    return {prefix: (arr.dtype.name, arr)}


def _assert_same_bits(got, want):
    got, want = _bits(got), _bits(want)
    assert got.keys() == want.keys()
    for path, (dt, w) in want.items():
        assert got[path][0] == dt, path
        np.testing.assert_array_equal(got[path][1], w, err_msg=path)


def _bf16_tree(seed=21):
    jcfg = jax_config.WhisperConfig.testing()
    return cast_params(jax_init_params(jcfg, seed=seed), jnp.bfloat16), jcfg


def test_a_jax_written_bf16_checkpoint_loads_with_the_same_bits(tmp_path):
    tree, jcfg = _bf16_tree()
    jax_save(str(tmp_path), tree, jcfg)
    got, cfg = load_checkpoint(str(tmp_path), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert got["decoder"]["embed_tokens"].dtype == torch.bfloat16
    _assert_same_bits(got, tree)


def test_a_port_saved_bf16_tree_is_flax_bytes_and_loads_in_jax(tmp_path):
    tree, jcfg = _bf16_tree(22)
    port = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
            torch.bfloat16), tree)
    # a mixed tree: one leaf kept in fp32
    port["encoder"]["layer_norm"]["scale"] = port["encoder"]["layer_norm"][
        "scale"].float()
    save_checkpoint(str(tmp_path), port,
                    torch_config.WhisperConfig(**dataclasses.asdict(jcfg)))
    back, _ = jax_load(str(tmp_path))
    assert back["decoder"]["embed_tokens"].dtype == jnp.bfloat16
    assert back["encoder"]["layer_norm"]["scale"].dtype == jnp.float32
    _assert_same_bits(back, port)
    with open(tmp_path / "params.msgpack", "rb") as f:
        assert f.read() == serialization.msgpack_serialize(
            jax.tree_util.tree_map(np.asarray, back))
    again, _ = load_checkpoint(str(tmp_path), device="cpu")
    _assert_same_bits(again, port)


_READER = r"""
import sys
for name in ("jax", "flax", "ml_dtypes"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import torch
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
params, cfg = load_checkpoint({path!r}, device="cpu")
t = params["decoder"]["embed_tokens"]
print(t.dtype, tuple(t.shape), int(t.view(torch.int16).long().sum()))
bad = [n for n in ("jax", "flax", "ml_dtypes") if sys.modules.get(n)]
print("IMPORTED", bad)
"""


def test_a_reader_without_jax_flax_or_ml_dtypes_loads_bf16(tmp_path):
    tree, jcfg = _bf16_tree(23)
    jax_save(str(tmp_path), tree, jcfg)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _READER.format(root=ROOT, path=str(tmp_path))],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    table = np.asarray(tree["decoder"]["embed_tokens"]).view(np.int16)
    want = (f"torch.bfloat16 {table.shape} "
            f"{int(table.astype(np.int64).sum())}")
    assert out.stdout.splitlines() == [want, "IMPORTED []"], out.stdout
