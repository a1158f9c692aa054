"""PyTorch port: the in-flight batcher (``runtime/ifb.py``) against the JAX
package's ``InflightBatcher`` and against the port's own lockstep
``transcribe_tokens``, on the same weights and mels: float, int8 and fp8
lanes, incremental submission, double buffering (the environment switch,
as ``tests/test_ifb.py`` sets it), adaptive and fixed segments, and the
lanes' final state (idle and retired lanes included) against JAX's.

Tokens exactly; the lanes' float self caches within 1e-5 (fp32 through two
layers, sums in another order), quantized ones exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.runtime import ifb as jax_ifb
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.runtime import generation, ifb
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

N_REQ, LANES, SEG, NEW = 5, 2, 3, 9
KINDS = ["auto", "int8", "fp8"]


class _Model:
    def __init__(self):
        self.jcfg = jax_config.WhisperConfig.testing()
        self.cfg = torch_config.WhisperConfig(
            **dataclasses.asdict(self.jcfg))
        self.ref = init_params(self.jcfg, seed=0)
        self.params = params_from_numpy(self.ref, "cpu")
        self.mels = np.random.default_rng(0).standard_normal(
            (N_REQ, 2 * self.jcfg.max_source_positions,
             self.jcfg.num_mel_bins)).astype(np.float32)

    def gen(self, kv, **kw):
        return torch_config.GenerationConfig(max_new_tokens=NEW,
                                             kv_cache_dtype=kv, **kw)

    def batcher(self, kv, lanes=LANES, seg=SEG, **kw):
        return ifb.InflightBatcher(self.params, self.cfg, self.gen(kv),
                                   num_lanes=lanes, segment_steps=seg,
                                   device="cpu", **kw)

    def lockstep(self, kv):
        toks, lens = generation.transcribe_tokens(
            self.params, self.cfg, self.mels, self.gen(kv), device="cpu")
        return [toks[i, :lens[i]].numpy() for i in range(N_REQ)]


def drain(b, mels):
    rids = [b.submit(m) for m in mels]
    b.run()
    return [b.fetch(r) for r in rids]


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def model():
    return _Model()


@pytest.fixture(scope="module")
def jax_runs(model):
    """One JAX batcher a cache kind, drained over every mel: its rows and
    its final lane state."""
    out = {}
    for kv in KINDS:
        g = jax_config.GenerationConfig(max_new_tokens=NEW, kv_cache_dtype=kv)
        b = jax_ifb.InflightBatcher(model.ref, model.jcfg, g,
                                    num_lanes=LANES, segment_steps=SEG)
        rows = drain(b, model.mels)
        out[kv] = ([np.asarray(r) for r in rows], b.state)
    return out


@pytest.fixture(scope="module")
def lockstep(model):
    return {kv: model.lockstep(kv) for kv in KINDS}


@pytest.fixture(scope="module")
def port_runs(model):
    out = {}
    for kv in KINDS:
        b = model.batcher(kv)
        out[kv] = (drain(b, model.mels), b)
    return out


@pytest.mark.parametrize("kv", KINDS)
def test_batcher_equals_jax_and_lockstep(jax_runs, lockstep, port_runs, kv):
    rows, b = port_runs[kv]
    assert_rows_equal(rows, jax_runs[kv][0])
    assert_rows_equal(rows, lockstep[kv])
    assert len(b.state.self_kv) == (2 if kv == "auto" else 4)
    assert len(b.state.cross_kv) == (2 if kv == "auto" else 4)


def _raw(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@pytest.mark.parametrize("kv", KINDS)
def test_lane_state_equals_jax_idle_lanes_included(jax_runs, port_runs, kv):
    """Every lane steps, held or not, at min(pos + 1, max_len - 1): the
    drained lanes' tokens, positions, flags and self caches (the rows
    idle and retired lanes wrote too) equal JAX's."""
    state = port_runs[kv][1].state
    ref = jax_runs[kv][1]
    for name in ("tokens", "pos", "active", "finished"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for got, want in zip(state.self_kv, ref.self_kv):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(_raw(got), _raw(want))


@pytest.mark.parametrize("kv", KINDS)
def test_double_buffered_equals_plain(model, port_runs, monkeypatch, kv):
    """WHISPER_TPU_IFB_DOUBLE_BUFFER=1 keeps a segment in flight past the
    read; lanes retire and re-admit behind it (the epoch guard). Seven
    requests, so some lanes turn over twice."""
    monkeypatch.setenv("WHISPER_TPU_IFB_DOUBLE_BUFFER", "1")
    b = model.batcher(kv)
    assert b._double_buffer
    mels = np.concatenate([model.mels, model.mels[:2]])
    rows = drain(b, mels)
    want = port_runs[kv][0]
    assert_rows_equal(rows, want + want[:2])


def test_incremental_submission_equals_lockstep(model, lockstep):
    """Requests submitted while others are mid-flight, and a segment run
    with no lane held, still come out right."""
    b = model.batcher("int8")
    r0 = b.submit(model.mels[0])
    b._dispatch_segment()          # no lane held yet: changes nothing
    b._retire_and_admit()
    b._dispatch_segment()
    r1, r2 = b.submit(model.mels[1]), b.submit(model.mels[2])
    b.run()
    assert_rows_equal([b.fetch(r) for r in (r0, r1, r2)],
                      lockstep["int8"][:3])


@pytest.mark.parametrize("seg,adaptive", [(1, True), (8, True), (8, False),
                                          (40, True)])
def test_tokens_do_not_depend_on_the_segments(model, port_runs, seg,
                                              adaptive):
    b = model.batcher("auto", seg=seg, adaptive_segments=adaptive)
    assert b._adaptive == (adaptive and max(4, seg // 4) < seg)
    before = generation.LOOP.eager_steps
    assert_rows_equal(drain(b, model.mels), port_runs["auto"][0])
    assert generation.LOOP.eager_steps - before == b.steps_run


def test_short_segments_run_while_requests_wait(model):
    """With requests queued the batcher runs max(4, segment_steps // 4)
    steps a segment, with the queue empty segment_steps."""
    b = model.batcher("auto", seg=16)
    for m in model.mels:
        b.submit(m)
    b._retire_and_admit()
    b._dispatch_segment()
    assert b.steps_run == 4           # three requests still wait
    while b._queue:
        b._retire_and_admit(b._dispatch_segment())
    n = b.steps_run
    b._dispatch_segment()
    assert b.steps_run - n == 16


def test_batcher_places_numpy_weights_on_its_device(model):
    b = ifb.InflightBatcher(model.ref, model.cfg, model.gen("auto"),
                            num_lanes=2, device="cpu")
    leaf = b.params["decoder"]["embed_tokens"]
    assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"


def test_lane_step_with_no_live_lane_changes_nothing_read(model):
    b = model.batcher("int8")
    before = [t.clone() for t in (b.state.tokens, b.state.pos, b._flags)]
    b._step()
    for t, s in zip((b.state.tokens, b.state.pos, b._flags), before):
        assert torch.equal(t, s)


def test_a_recording_tallies_only_its_own_thread():
    """While one thread records a capture, another thread's launches count
    in the wrapper's total and not in the recording's tally, which is what
    a capture takes back and its replays add."""
    import threading

    from whisper_trtllm_tpu_torch.ops.kernels import _launches

    def wrapper():
        pass

    wrapper.launches = 0
    with _launches.recording() as mine:
        _launches.count(wrapper)
        other = threading.Thread(
            target=lambda: [_launches.count(wrapper) for _ in range(5)])
        other.start()
        other.join()
        _launches.count(wrapper)
    _launches.count(wrapper)  # after the recording: not tallied
    assert mine == {wrapper: 2} and wrapper.launches == 8
