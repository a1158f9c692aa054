"""PyTorch port: the training path against the JAX package on the CPU, at
``WhisperConfig.testing()`` with the JAX ``init_params`` carried over by
``params_from_numpy`` and inputs drawn from numpy seeds.

Tolerances: logits 1e-5 and the guided-attention penalty 1e-6 (fp32 sums
in another order); the loss 1e-6 relative and every leaf's gradient 1e-5
of that leaf's largest |g|; three AdamW steps: losses 1e-5 relative and
parameters 1e-2 of the summed learning rates absolute (Adam moves a
component by up to ~lr a step whatever its gradient's size, so a
component whose gradient is at the level of fp32 reordering noise may
move differently); remat against no remat 1e-5 relative, as the JAX
package's own test. The checkpoint round trip is bit-equal, and its
bytes equal flax's.
"""

import dataclasses
import functools
import importlib
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu import training as jax_training
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jax_load
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch import training
from whisper_trtllm_tpu_torch.models.whisper import model
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_numpy,
    save_checkpoint,
)
from whisper_trtllm_tpu_torch.utils.device import to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules, not the package's functions of the same names
k_flash = importlib.import_module(
    "whisper_trtllm_tpu_torch.ops.kernels.flash_attention")
k_norm = importlib.import_module(
    "whisper_trtllm_tpu_torch.ops.kernels.layer_norm")


def _configs():
    jcfg = jax_config.WhisperConfig.testing()
    return jcfg, torch_config.WhisperConfig(**dataclasses.asdict(jcfg))


def _batch(cfg, seed, b=2, s=8):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal(
        (b, 2 * cfg.max_source_positions, cfg.num_mel_bins)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s - 1), np.float32)
    mask[-1, s // 2:] = 0.0  # a shorter last target
    return mel, tokens, mask


def _flat(tree, prefix=""):
    """path → numpy leaf, keys sorted (the JAX tree's leaf order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = to_numpy(tree)  # bfloat16 widened to float32
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("flash_cross", [False, True])
def test_decode_full_logits_match_jax(flash_cross):
    jcfg, cfg = _configs()
    ref_p = init_params(jcfg, seed=1)
    p = params_from_numpy(ref_p, "cpu")
    _, tokens, _ = _batch(jcfg, 2)
    enc = np.random.default_rng(3).standard_normal(
        (2, jcfg.max_source_positions, jcfg.d_model)).astype(np.float32)
    ref = jax_model.decode_full(ref_p, jcfg, jnp.asarray(tokens),
                                jnp.asarray(enc), flash_cross=flash_cross)
    out = model.decode_full(p, cfg, torch.from_numpy(tokens),
                            torch.from_numpy(enc), flash_cross=flash_cross)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_full_guided_attention_matches_jax():
    jcfg, cfg = _configs()
    ref_p = init_params(jcfg, seed=4)
    p = params_from_numpy(ref_p, "cpu")
    _, tokens, mask = _batch(jcfg, 5)
    enc = np.random.default_rng(6).standard_normal(
        (2, jcfg.max_source_positions, jcfg.d_model)).astype(np.float32)
    ga = jax_training.guided_attn_weights(7, jcfg.max_source_positions)
    ref, ref_pen = jax_model.decode_full(
        ref_p, jcfg, jnp.asarray(tokens[:, :-1]), jnp.asarray(enc),
        flash_cross=True, ga_weights=jnp.asarray(ga),
        ga_row_mask=jnp.asarray(mask))
    out, pen = model.decode_full(
        p, cfg, torch.from_numpy(tokens[:, :-1]), torch.from_numpy(enc),
        flash_cross=True, ga_weights=torch.from_numpy(ga),
        ga_row_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert pen.dim() == 0 and float(pen) > 0
    np.testing.assert_allclose(float(pen), float(ref_pen), atol=1e-6)


def test_guided_attn_weights_equal_jax():
    np.testing.assert_array_equal(training.guided_attn_weights(31, 1500),
                                  jax_training.guided_attn_weights(31, 1500))


@pytest.mark.parametrize("guided", [False, True], ids=["ce", "ce+ga"])
@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
def test_loss_and_gradients_match_jax_value_and_grad(guided, remat):
    jcfg, cfg = _configs()
    ref_p = init_params(jcfg, seed=7)
    p = params_from_numpy(ref_p, "cpu")
    mel, tokens, mask = _batch(jcfg, 8)
    ga = (jax_training.guided_attn_weights(7, jcfg.max_source_positions)
          if guided else None)
    scale = 0.7 if guided else None
    loss_fn = functools.partial(jax_training.cross_entropy_loss,
                                remat_encoder=remat)
    ref_loss, ref_g = jax.value_and_grad(loss_fn)(
        ref_p, jcfg, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask),
        None if ga is None else jnp.asarray(ga),
        None if scale is None else jnp.float32(scale))
    loss, grads = training.loss_and_grads(p, cfg, mel, tokens, mask, ga,
                                          scale, remat=remat)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    ref_g, grads = _flat(ref_g), _flat(grads)
    assert ref_g.keys() == grads.keys()
    for path, r in ref_g.items():
        g = grads[path]
        assert np.abs(r).max() > 0, path
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0,
                                   err_msg=path)
    # the caller's tensors stay leaves that do not require grad
    assert not any(t.requires_grad for t in training.train.tree_leaves(p))


def test_schedule_matches_optax():
    ours = training.warmup_cosine_decay_schedule(1e-6, 1e-4, 5, 23, 5e-6)
    ref = optax.warmup_cosine_decay_schedule(1e-6, 1e-4, 5, 23, 5e-6)
    for count in range(30):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)


@pytest.mark.parametrize("lr", ["const", "schedule"])
def test_three_adamw_steps_match_optax(lr):
    jcfg, cfg = _configs()
    ref_p = init_params(jcfg, seed=9)
    p = params_from_numpy(ref_p, "cpu")
    mel, tokens, mask = _batch(jcfg, 10)
    if lr == "const":
        ref_opt, opt = optax.adamw(1e-4), None  # the defaults on both sides
        lr_sum = 3e-4
    else:
        kw = dict(init_value=1e-5, peak_value=1e-3, warmup_steps=2,
                  decay_steps=5, end_value=1e-4)
        ref_opt = optax.adamw(optax.warmup_cosine_decay_schedule(**kw))
        schedule = training.warmup_cosine_decay_schedule(**kw)
        opt = training.AdamW(schedule)
        lr_sum = sum(schedule(c) for c in range(3))
    ref_init, ref_step = jax_training.make_train_step(jcfg, ref_opt)
    init, step = training.make_train_step(cfg, opt)
    ref_state, state = ref_init(ref_p), init(p)
    ref_p = jax.tree_util.tree_map(jnp.asarray, ref_p)
    for _ in range(3):
        ref_p, ref_state, ref_loss = ref_step(ref_p, ref_state, mel, tokens,
                                              mask)
        p, state, loss = step(p, state, mel, tokens, mask)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert state["count"] == 3
    ref_f, got = _flat(ref_p), _flat(p)
    for path, r in ref_f.items():
        np.testing.assert_allclose(got[path], r, atol=1e-2 * lr_sum, rtol=0,
                                   err_msg=path)


def test_remat_step_matches_plain():
    jcfg, cfg = _configs()
    mel, tokens, mask = _batch(jcfg, 11)
    losses = {}
    for remat in (False, True):
        p = params_from_numpy(init_params(jcfg, seed=0), "cpu")
        init, step = training.make_train_step(cfg, training.AdamW(1e-3),
                                              remat=remat)
        state = init(p)
        ls = []
        for _ in range(3):
            p, state, loss = step(p, state, mel, tokens, mask)
            ls.append(float(loss))
        losses[remat] = ls
    assert losses[False][-1] < losses[False][0]
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-5)


def test_train_step_refuses_a_mesh_and_int_weights():
    """A mesh argument that is not a (data, model) mesh is refused (the
    sharded step itself is held against JAX in
    tests/test_torch_parallel_train.py)."""
    jcfg, cfg = _configs()
    with pytest.raises(TypeError, match="mesh"):
        training.make_train_step(cfg, mesh=object())
    p = params_from_numpy(init_params(jcfg, seed=0), "cpu")
    p["decoder"]["embed_tokens"] = p["decoder"]["embed_tokens"].to(torch.int8)
    mel, tokens, mask = _batch(jcfg, 12)
    with pytest.raises(TypeError, match="float"):
        training.loss_and_grads(p, cfg, mel, tokens, mask)


def _counted(monkeypatch):
    """Calls of the K1, K4 and K5 wrappers: on the card each is one
    launch, on the CPU each takes the plain version."""
    calls = {"flash_fwd": 0, "flash_bwd": 0, "layer_norm": 0}

    def wrap(module, name):
        real = getattr(module, name)

        def spy(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, spy)

    wrap(k_flash, "flash_fwd")
    wrap(k_flash, "flash_bwd")
    wrap(k_norm, "layer_norm")
    return calls


@pytest.mark.parametrize("guided,remat", [(False, False), (True, True)])
def test_kernel_calls_per_step_follow_the_dispatch(monkeypatch, guided,
                                                   remat):
    """The launch counts chip_smoke.py holds the card to: without guided
    attention the cross attention runs K1 and K4, with it the plain
    formula; remat runs each encoder layer's K1 and two K5 again."""
    jcfg, cfg = _configs()
    p = params_from_numpy(init_params(jcfg, seed=0), "cpu")
    mel, tokens, mask = _batch(jcfg, 13)
    ga = (training.guided_attn_weights(7, cfg.max_source_positions)
          if guided else None)
    init, step = training.make_train_step(cfg, remat=remat)
    state = init(p)
    calls = _counted(monkeypatch)
    step(p, state, mel, tokens, mask, ga, 1.0 if guided else None)
    le, ld = cfg.encoder_layers, cfg.decoder_layers
    enc_fwd = le * (2 if remat else 1)
    assert calls == {
        "flash_fwd": enc_fwd + (0 if guided else ld),
        "flash_bwd": le + (0 if guided else ld),
        "layer_norm": 2 * enc_fwd + 1 + 3 * ld + 1,
    }


def test_saved_checkpoint_loads_bit_equal_in_jax_and_the_port(tmp_path):
    from flax import serialization

    jcfg, cfg = _configs()
    ref = init_params(jcfg, seed=14)
    p = params_from_numpy(ref, "cpu")
    bf16 = "/decoder/layer_norm/bias"
    p["decoder"]["layer_norm"]["bias"] = (
        p["decoder"]["layer_norm"]["bias"].bfloat16())  # written as bf16
    save_checkpoint(str(tmp_path), p, cfg)
    back, back_cfg = jax_load(str(tmp_path))
    assert back_cfg == jcfg
    assert back["decoder"]["layer_norm"]["bias"].dtype == jnp.bfloat16
    got, want = _flat(back), _flat(p)
    assert got.keys() == want.keys()
    for path, w in want.items():
        # the bf16 leaf compares widened to fp32 (exact) on both sides
        assert got[path].dtype == (jnp.bfloat16 if path == bf16
                                   else np.float32)
        np.testing.assert_array_equal(got[path].astype(np.float32), w)
    with open(tmp_path / "params.msgpack", "rb") as f:
        assert f.read() == serialization.msgpack_serialize(
            jax.tree_util.tree_map(np.asarray, back))
    port, port_cfg = load_checkpoint(str(tmp_path), device="cpu")
    assert port_cfg == cfg
    assert port["decoder"]["layer_norm"]["bias"].dtype == torch.bfloat16
    for path, w in _flat(port).items():
        np.testing.assert_array_equal(w, got[path].astype(np.float32))
    assert torch.equal(port["decoder"]["layer_norm"]["bias"],
                       p["decoder"]["layer_norm"]["bias"])


def test_finetune_cli_runs_on_the_cpu_and_writes_a_checkpoint(tmp_path):
    jcfg, cfg = _configs()
    save_checkpoint(str(tmp_path / "init"), params_from_numpy(
        init_params(jcfg, seed=15), "cpu"), cfg)
    rng = np.random.default_rng(16)
    data = [(rng.standard_normal((2 * cfg.max_source_positions,
                                  cfg.num_mel_bins)).astype(np.float32),
             [cfg.decoder_start_token_id, 11]
             + list(rng.integers(20, 90, 3 + i)) + [cfg.eos_token_id])
            for i in range(4)]
    data = [(m.T, t) for m, t in data]  # (M, T) mels are transposed
    with open(tmp_path / "train.pkl", "wb") as f:
        pickle.dump(data, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.finetune",
         "--checkpoint", str(tmp_path / "init"), "--dataset",
         str(tmp_path / "train.pkl"), "--output", str(tmp_path / "ft"),
         "--epochs", "2", "--batch", "2", "--lr", "1e-3", "--max-target-len",
         "8", "--guided-attn", "1", "--remat", "--warmup-steps", "2",
         "--augment-mel", "0.1", "--save-every", "1", "--cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "epoch 1: loss" in out.stdout and "guided-attn 0.750" in out.stdout
    launches = json.loads(out.stdout.split("kernel launches ")[1])
    assert launches["flash_bwd"] == 0  # the CPU launches no kernel
    tuned, tuned_cfg = load_checkpoint(str(tmp_path / "ft"), device="cpu")
    first, _ = load_checkpoint(str(tmp_path / "init"), device="cpu")
    assert tuned_cfg == cfg
    moved = _flat(tuned)["/decoder/embed_tokens"] - _flat(first)[
        "/decoder/embed_tokens"]
    assert np.isfinite(moved).all() and np.abs(moved).max() > 0


def test_finetune_cli_refuses_parallelism(tmp_path, monkeypatch):
    """Outside ``torchrun`` (no RANK in the environment); under it the
    CLI trains over the mesh (tests/test_torch_parallel_train.py)."""
    from whisper_trtllm_tpu_torch.cli import finetune

    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        finetune.main(["--checkpoint", str(tmp_path), "--dataset", "x",
                       "--output", "y", "--data-parallel", "2", "--cpu"])


def test_pad_tokens_equals_the_jax_cli():
    from cli.finetune import _pad_tokens as jax_pad
    from whisper_trtllm_tpu_torch.cli.finetune import _pad_tokens

    seqs = [[1, 5, 6, 2], [1, 2], list(range(1, 12))]
    for a, b in zip(_pad_tokens(seqs, 2, 8), jax_pad(seqs, 2, 8)):
        np.testing.assert_array_equal(a, b)
