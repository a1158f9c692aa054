"""PyTorch port: engine export (``runtime/export.py``, ``utils/engine.py``,
``WhisperSession.export_engine``) against the JAX package's engines, on
the CPU, at ``WhisperConfig.testing()`` (the cases of
``tests/test_session.py``'s engine tests).

- fp32, and bf16 compute with int8 weights: an engine file round-trips;
  its tokens and lengths equal the session's and the JAX engine's, and a
  seed-1 tree through the same chain gives a session's tokens on it (the
  weights are an argument: refit).
- An engine loads and runs in a fresh interpreter where importing the
  model code or the runtime fails.
- A process that exports before it decodes transcribes the tokens of a
  process that never exported: tracing leaves no fake tensor in a
  module-level cache (``model._encoder_length``, ``_cross_mask``).
- The kernels' operators (``torch.ops.wtpu.*``) give their outputs' shapes
  and dtypes to a tracer (fake tensors on the meta device); their CUDA
  implementations run on the card (``tests/test_torch_gpu.py``).
- Beam search (``num_beams`` 2 and 4): the engine's tokens and lengths
  equal the port session's and the JAX session's best hypothesis, also in
  a fresh interpreter without the model code; a beam engine without its
  finalize program is refused.
- A greedy engine file of format 1 (written before beam search was
  exported) loads and runs.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.runtime import WhisperSession as JaxSession
from whisper_trtllm_tpu.utils.engine import load_engine as jax_load_engine
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    params_from_numpy,
    save_checkpoint,
)
from whisper_trtllm_tpu_torch.utils.engine import load_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"fp32": (6, 2, {}),
         "bf16_int8": (5, 1, dict(compute_dtype="bfloat16",
                                  weight_dtype="int8"))}


def _trees(jcfg, seed):
    jparams = init_params(jcfg, seed=seed)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _export(case, tmp_path_factory):
    """One case: both packages' sessions on the seed-0 and seed-1 trees,
    the port's and JAX's engines exported from the seed-0 sessions, the
    mels."""
    max_new, batch, rt = CASES[case]
    jcfg = jax_config.WhisperConfig.testing()
    tcfg = torch_config.WhisperConfig(**dataclasses.asdict(jcfg))
    mel = np.random.default_rng(0).standard_normal(
        (batch, 2 * jcfg.max_source_positions, jcfg.num_mel_bins)
    ).astype(np.float32)
    out = {"mel": mel, "cfg": tcfg, "dir": tmp_path_factory.mktemp("eng")}
    for seed in (0, 1):
        jparams, tparams = _trees(jcfg, seed)
        out[f"jax{seed}"] = JaxSession(
            jparams, jcfg, jax_config.GenerationConfig(max_new_tokens=max_new),
            jax_config.RuntimeConfig(**rt))
        out[f"torch{seed}"] = WhisperSession(
            tparams, tcfg, torch_config.GenerationConfig(
                max_new_tokens=max_new), torch_config.RuntimeConfig(**rt),
            device="cpu")
    out["path"] = str(out["dir"] / "whisper.engine")
    assert out["torch0"].export_engine(out["path"], batch=batch) > 0
    jpath = str(out["dir"] / "jax.engine")
    assert out["jax0"].export_engine(jpath, batch=batch) > 0
    out["jax_engine"] = jax_load_engine(jpath)
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return {case: _export(case, tmp_path_factory) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_round_trips_as_the_session_and_jax_engine(engines, case):
    exported = engines[case]
    mel, sess, jsess = exported["mel"], exported["torch0"], exported["jax0"]
    ref_toks, ref_lens = sess.transcribe_features(mel)
    eng = load_engine(exported["path"])
    assert eng.batch == mel.shape[0] and eng.meta["device"] == "cpu"
    toks, lens = eng(sess.params, mel)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    jmel = jnp.asarray(mel, jsess._dtype)
    jtoks, jlens = exported["jax_engine"](jsess.params, jmel)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    # refit: the seed-1 tree through the same chain, the same engine
    sess1, jsess1 = exported["torch1"], exported["jax1"]
    toks1, _ = eng(sess1.params, mel)
    np.testing.assert_array_equal(toks1.numpy(),
                                  sess1.transcribe_features(mel)[0])
    jtoks1, _ = exported["jax_engine"](jsess1.params, jmel)
    np.testing.assert_array_equal(toks1.numpy(), np.asarray(jtoks1))
    assert eng.captures == 0 and eng.eager_steps > 0
    with pytest.raises(ValueError, match="exported at batch"):
        eng(sess.params, np.concatenate([mel, mel]))


_LOADER = r"""
import json, sys
sys.modules["whisper_trtllm_tpu_torch.models"] = None
sys.modules["whisper_trtllm_tpu_torch.runtime"] = None
sys.path.insert(0, {root!r})
import numpy as np
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
from whisper_trtllm_tpu_torch.utils.engine import load_engine
toks, lens = [], []
for i in range(1, len(sys.argv), 3):
    params, _ = load_checkpoint(sys.argv[i + 1], device="cpu")
    t, n = load_engine(sys.argv[i])(params, np.load(sys.argv[i + 2]))
    toks.append(t.tolist())
    lens.append(n.tolist())
print(json.dumps([toks, lens, sorted(
    n for n in sys.modules if sys.modules[n] is not None and n.startswith(
        ("whisper_trtllm_tpu_torch.models",
         "whisper_trtllm_tpu_torch.runtime")))]))
"""


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_engine_runs_without_the_model_code(engines):
    """Both cases' engines, one after the other in one fresh interpreter."""
    args = []
    for exported in engines.values():
        sess, d = exported["torch0"], exported["dir"]
        save_checkpoint(str(d / "tree"), sess.params, exported["cfg"])
        np.save(d / "mel.npy", exported["mel"])
        args += [exported["path"], str(d / "tree"), str(d / "mel.npy")]
    out = subprocess.run(
        [sys.executable, "-c", _LOADER.format(root=ROOT), *args],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    toks, lens, imported = json.loads(out.stdout.strip().splitlines()[-1])
    assert imported == []
    for i, exported in enumerate(engines.values()):
        ref_toks, ref_lens = exported["torch0"].transcribe_features(
            exported["mel"])
        assert toks[i] == ref_toks.tolist() and lens[i] == ref_lens.tolist()


_EXPORT_FIRST = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
from whisper_trtllm_tpu_torch.config import GenerationConfig, WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper import init_params
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
cfg = WhisperConfig.testing()
sess = WhisperSession(init_params(cfg, 0, device="cpu"), cfg,
                      GenerationConfig(max_new_tokens=6), device="cpu")
if sys.argv[1] != "-":
    sess.export_engine(sys.argv[1], batch=2)
mel = np.random.default_rng(0).standard_normal(
    (2, 2 * cfg.max_source_positions, cfg.num_mel_bins)).astype(np.float32)
toks, lens = sess.transcribe_features(mel)
print(json.dumps([toks.tolist(), lens.tolist()]))
"""


def test_exporting_first_leaves_later_decodes_alone(tmp_path):
    """The pin of the cache fault: before the fix, a process whose first
    decode came after an export decoded pad after the start token."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _EXPORT_FIRST.format(root=ROOT), arg],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for arg in (str(tmp_path / "e.engine"), "-")]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    exported_first, never = (json.loads(o.strip().splitlines()[-1])
                             for o, _ in outs)
    assert exported_first == never
    assert len(set(never[0][0][1:])) > 1 or never[0][0][1] != 2


@pytest.mark.parametrize("op", ["layer_norm", "flash_fwd", "decode_attn",
                                "fused_decoder_step"])
def test_kernel_operators_give_shapes_to_a_tracer(op):
    meta = dict(device="meta")
    x = torch.empty(3, 1, 64, **meta)
    if op == "layer_norm":
        out = torch.ops.wtpu.layer_norm(x, torch.empty(64, **meta), None,
                                        1e-5)
        want = x
    elif op == "flash_fwd":
        q = torch.empty(2, 4, 24, 16, dtype=torch.bfloat16, **meta)
        out = torch.ops.wtpu.flash_fwd(q, q, q, False)
        want = q
    elif op == "decode_attn":
        q = torch.empty(2, 4, 1, 16, **meta)
        cache = torch.empty(2, 4, 32, 16, dtype=torch.int8, **meta)
        scale = torch.empty(2, 4, 32, 1, **meta)
        out = torch.ops.wtpu.decode_attn(
            q, cache, cache, torch.empty((), dtype=torch.int32, **meta),
            scale, scale, False)
        want = q
    else:
        h = torch.empty(2, 128, **meta)
        w = [torch.empty(128, 128, **meta), None] * 8
        cache = torch.empty(2, 2, 8, 64, **meta)
        pos = torch.empty((), dtype=torch.int32, **meta)
        out = torch.ops.wtpu.fused_decoder_step(h, h, pos, w, cache, cache,
                                                cache, cache, pos)
        want = h
    assert out.shape == want.shape and out.dtype == want.dtype
    assert out.device.type == "meta"


BEAM_NEW = 6


@pytest.fixture(scope="module")
def beam_engines(engines):
    """The fp32 case's trees: for K 2 and 4, the port's beam session, its
    engine file and the JAX beam session's best hypothesis."""
    exported = engines["fp32"]
    jcfg = jax_config.WhisperConfig.testing()
    jparams, _ = _trees(jcfg, 0)
    out = {}
    for k in (2, 4):
        sess = WhisperSession(
            exported["torch0"].params, exported["cfg"],
            torch_config.GenerationConfig(max_new_tokens=BEAM_NEW,
                                          num_beams=k), device="cpu")
        path = str(exported["dir"] / f"beam{k}.engine")
        assert sess.export_engine(path, batch=exported["mel"].shape[0]) > 0
        jsess = JaxSession(jparams, jcfg, jax_config.GenerationConfig(
            max_new_tokens=BEAM_NEW, num_beams=k))
        out[k] = dict(sess=sess, path=path, dir=exported["dir"],
                      cfg=exported["cfg"], mel=exported["mel"],
                      jax=[np.asarray(x) for x in jsess.transcribe_features(
                          exported["mel"])])
    return out


@pytest.mark.parametrize("k", [2, 4])
def test_beam_engine_equals_the_sessions_and_jax_best_hypothesis(
        beam_engines, k):
    b = beam_engines[k]
    want_toks, want_lens = b["sess"].transcribe_features(b["mel"])
    eng = load_engine(b["path"])
    assert eng.meta["num_beams"] == k and eng.meta["format"] == 2
    toks, lens = eng(b["sess"].params, b["mel"])
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    np.testing.assert_array_equal(toks.numpy(), b["jax"][0])
    np.testing.assert_array_equal(lens.numpy(), b["jax"][1])
    assert eng.captures == 0 and 0 < eng.eager_steps <= BEAM_NEW


def test_beam_engine_runs_without_the_model_code(beam_engines):
    b = beam_engines[4]
    save_checkpoint(str(b["dir"] / "beam_tree"), b["sess"].params, b["cfg"])
    np.save(b["dir"] / "beam_mel.npy", b["mel"])
    out = subprocess.run(
        [sys.executable, "-c", _LOADER.format(root=ROOT), b["path"],
         str(b["dir"] / "beam_tree"), str(b["dir"] / "beam_mel.npy")],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    toks, lens, imported = json.loads(out.stdout.strip().splitlines()[-1])
    assert imported == []
    want_toks, want_lens = b["sess"].transcribe_features(b["mel"])
    assert toks[0] == want_toks.tolist() and lens[0] == want_lens.tolist()


def _rewrite(src: str, dst: str, meta=None, drop=()) -> None:
    """Copy an engine file, its meta replaced by ``meta(old)`` and the
    members in ``drop`` left out."""
    import zipfile

    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name in drop:
                continue
            data = zin.read(name)
            if name == "meta.json" and meta is not None:
                data = json.dumps(meta(json.loads(data)))
            zout.writestr(name, data)


def test_a_format_1_greedy_engine_still_loads_and_runs(engines):
    exported = engines["fp32"]
    path = str(exported["dir"] / "format1.engine")

    def old(meta):
        meta = {k: v for k, v in meta.items() if k != "num_beams"}
        return dict(meta, format=1)

    _rewrite(exported["path"], path, old)
    eng = load_engine(path)
    assert eng.meta["num_beams"] == 1
    sess, mel = exported["torch0"], exported["mel"]
    toks, lens = eng(sess.params, mel)
    ref_toks, ref_lens = sess.transcribe_features(mel)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(lens.numpy(), ref_lens)


def test_export_engine_refuses_beam_search(beam_engines):
    """What is still refused of a beam engine: one whose file lacks the
    finalize program that ends the search."""
    b = beam_engines[2]
    path = str(b["dir"] / "beam_no_finalize.engine")
    _rewrite(b["path"], path, drop=("finalize.pt2",))
    with pytest.raises(ValueError, match="finalize"):
        load_engine(path)
