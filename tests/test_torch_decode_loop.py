"""PyTorch port: the decode loop (``runtime/generation.py``) against the JAX
package's ``_greedy_decode_impl`` at a tiny config (2 encoder and 2
decoder layers, d 32, vocabulary 97, 20 positions), on the same weights
(JAX ``init_params`` carried over) and the same encoder states.

Every deterministic configuration is held TOKEN-EQUAL, tokens and lengths:
the plain loop, each penalty and word rule, min-new-tokens, timestamps,
the prompted path, quantized KV caches in both cross layouts, budgets that
are not a multiple of the host's check interval, and batches that finish
early (the loop then runs on past the last EOS by up to
``FINISH_CHECK_EVERY - 1`` steps that write pad). ``detect_language``
equals JAX's. A sampled decode cannot equal JAX's (its threefry stream is
not reproduced): it is held to one draw a seed, another draw with another
seed, the forced prefix and the suppressed tokens, and to the greedy
tokens where top-k 1 or a tiny top-p leaves one token.

The captured CUDA graph is card-only (``tests/test_torch_gpu.py``); its
cache's bookkeeping (weights that die, ``refit``, the bound) is plain
Python and is checked here.
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.runtime import generation as jax_gen
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.runtime import generation
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

BATCH = 3
CFG = dict(max_target_positions=20, no_timestamps_token_id=60,
           max_initial_timestamp_index=5)
N = generation.FINISH_CHECK_EVERY


class _Model:
    """One JAX weight tree, its port, and encoder states from a mel."""

    def __init__(self, eos_bias: float = 0.0, **cfg):
        self.jcfg = jax_config.WhisperConfig.testing(**{**CFG, **cfg})
        self.cfg = torch_config.WhisperConfig(
            **dataclasses.asdict(self.jcfg))
        ref = init_params(self.jcfg, seed=0)
        if eos_bias:
            # a final-LayerNorm bias along EOS's embedding: EOS comes up
            # within a few steps, in some lanes sooner than in others
            row = ref["decoder"]["embed_tokens"][self.jcfg.eos_token_id]
            ref["decoder"]["layer_norm"]["bias"] = (
                ref["decoder"]["layer_norm"]["bias"]
                + eos_bias * row / np.linalg.norm(row))
        self.ref, self.params = ref, params_from_numpy(ref, "cpu")
        # encoder states straight from the seed (the loop is what is
        # compared), large enough that the lanes decode apart
        self.enc = (np.random.default_rng(3).standard_normal(
            (BATCH, self.jcfg.max_source_positions, self.jcfg.d_model))
            * 4.0).astype(np.float32)

    def jax(self, prompt=None, **gen):
        g = jax_config.GenerationConfig(**gen)
        if prompt is None:
            out = jax_gen.greedy_decode(self.ref, self.jcfg,
                                        jnp.asarray(self.enc), g)
        else:
            out = jax_gen.greedy_decode_prompted(
                self.ref, self.jcfg, jnp.asarray(self.enc),
                jnp.asarray(prompt), g)
        return tuple(np.asarray(x) for x in out)

    def port(self, prompt=None, **gen):
        g = torch_config.GenerationConfig(**gen)
        enc = torch.from_numpy(self.enc)
        if prompt is None:
            out = generation.greedy_decode(self.params, self.cfg, enc, g)
        else:
            out = generation.greedy_decode_prompted(self.params, self.cfg,
                                                    enc, prompt, g)
        return tuple(x.numpy() for x in out)

    def check(self, prompt=None, **gen):
        """Port == JAX, tokens and lengths; returns the JAX pair."""
        ref = self.jax(prompt, **gen)
        generation.reset_loop_counts()
        toks, lens = self.port(prompt, **gen)
        np.testing.assert_array_equal(toks, ref[0])
        np.testing.assert_array_equal(lens, ref[1])
        # every step the lanes needed ran, and at most N - 1 more
        # (a prompt is teacher-forced by steps too)
        steps = generation.LOOP.steps
        assert steps <= toks.shape[1] - 1
        assert 0 <= steps - (int(lens.max()) - 1) < N
        return ref


@pytest.fixture(scope="module")
def plain():
    return _Model()


@pytest.fixture(scope="module")
def eos_model():
    return _Model(eos_bias=3.0)


@pytest.fixture(scope="module")
def plain_tokens(plain):
    return plain.check(max_new_tokens=12)


@pytest.fixture(scope="module")
def varied_tokens(plain):
    """A presence-penalized decode: no token repeats, so word rules taken
    from it bite at one place each."""
    return plain.check(max_new_tokens=19, presence_penalty=1.0)


def test_plain_loop_equals_jax(plain_tokens):
    toks, lens = plain_tokens
    assert toks.shape == (BATCH, 13) and (toks[:, 1] == 11).all()


@pytest.mark.parametrize("max_new_tokens", [1, 7, 8, 9, 11, 19, 40])
def test_budgets_around_the_check_interval_equal_jax(plain, max_new_tokens):
    plain.check(max_new_tokens=max_new_tokens)


def test_a_batch_that_finishes_early_equals_jax(eos_model):
    """Every lane finishes at EOS before the budget, each at another step:
    the loop overruns the last finish by steps that write pad."""
    toks, lens = eos_model.check(max_new_tokens=19, presence_penalty=1.0)
    assert len(set(lens.tolist())) > 1 and lens.max() < 9
    generation.reset_loop_counts()
    eos_model.port(max_new_tokens=19, presence_penalty=1.0)
    assert generation.LOOP.steps == N > int(lens.max()) - 1


@pytest.mark.parametrize("gen", [
    dict(presence_penalty=0.7), dict(presence_penalty=-0.5),
    dict(repetition_penalty=1.3), dict(repetition_penalty=0.7),
], ids=["presence", "presence-negative", "repetition", "repetition-below-1"])
def test_penalties_equal_jax(plain, plain_tokens, gen):
    toks, _ = plain.check(max_new_tokens=12, **gen)
    assert not np.array_equal(toks, plain_tokens[0])


def test_bad_words_equal_jax(plain, varied_tokens):
    """Words taken from a decode, so that each one bites: a one-token word
    and a two-token word."""
    t = varied_tokens[0]
    bad = ((int(t[0, 4]),), (int(t[1, 2]), int(t[1, 3])))
    toks, _ = plain.check(max_new_tokens=19, presence_penalty=1.0,
                          bad_words=bad)
    assert not (toks[:, 2:] == bad[0][0]).any()
    assert toks[1, 3] != t[1, 3]


def test_stop_words_equal_jax(plain, varied_tokens):
    """Each lane stops at a word of its own, at another step."""
    t = varied_tokens[0]
    stop = ((int(t[0, 5]), int(t[0, 6])), (int(t[1, 8]),), (int(t[2, 4]),))
    toks, lens = plain.check(max_new_tokens=19, presence_penalty=1.0,
                             stop_words=stop)
    assert lens.tolist() == [7, 9, 5]


def test_min_new_tokens_equal_jax(eos_model):
    _, base_lens = eos_model.check(max_new_tokens=12, presence_penalty=1.0)
    toks, lens = eos_model.check(max_new_tokens=12, presence_penalty=1.0,
                                 min_new_tokens=6)
    assert (lens >= 2 + 6 + 1).all() and (base_lens < 2 + 6 + 1).all()


def test_timestamps_equal_jax(plain):
    toks, lens = plain.check(max_new_tokens=12, return_timestamps=True)
    # the first free position is a timestamp within the initial bound
    assert (toks[:, 2] >= 61).all() and (toks[:, 2] <= 66).all()
    assert not (toks == 60).any()


def test_timestamps_need_the_no_timestamps_id():
    m = _Model(no_timestamps_token_id=None)
    with pytest.raises(ValueError):
        m.port(max_new_tokens=4, return_timestamps=True)


def test_every_processor_at_once_equals_jax(eos_model):
    eos_model.check(max_new_tokens=15, presence_penalty=0.3,
                    repetition_penalty=1.2, min_new_tokens=3,
                    bad_words=((13,), (4, 9)), stop_words=((10, 6),),
                    return_timestamps=True)


@pytest.mark.parametrize("kv,layout", [("int8", "auto"), ("fp8", "auto"),
                                       ("int8", "bhtd"), ("auto", "bhdt")])
def test_quantized_and_t_minor_caches_equal_jax(plain, kv, layout):
    plain.check(max_new_tokens=12, kv_cache_dtype=kv, cross_kv_layout=layout)


@pytest.mark.parametrize("gen", [
    dict(), dict(return_timestamps=True), dict(kv_cache_dtype="int8"),
    dict(bad_words=((13,), (4, 9)), stop_words=((10, 6),), min_new_tokens=2),
], ids=["plain", "timestamps", "int8-kv", "word-rules"])
def test_prompted_decode_equals_jax(plain, gen):
    """A four-token prompt teacher-forced through the step, then the
    processors from begin_index = 4."""
    prompt = np.asarray([[1, 11, 20 + i, 30 + i] for i in range(BATCH)],
                        np.int32)
    toks, _ = plain.check(prompt, max_new_tokens=9, **gen)
    np.testing.assert_array_equal(toks[:, :4], prompt)


def test_prompted_decode_of_the_plain_prefix_equals_the_plain_loop(plain):
    toks, lens = plain.port(max_new_tokens=12)
    prompt = np.asarray([[1, 11]] * BATCH, np.int32)
    ptoks, plens = plain.port(prompt, max_new_tokens=11)
    np.testing.assert_array_equal(ptoks, toks)
    np.testing.assert_array_equal(plens, lens)


def test_prompted_beam_is_refused(plain):
    with pytest.raises(NotImplementedError):
        plain.port(np.ones((BATCH, 2), np.int32), max_new_tokens=3,
                   num_beams=2)


def test_detect_language_equals_jax(plain):
    ids = [13, 17, 40, 41, 50]
    ref = np.asarray(jax_gen.detect_language(
        plain.ref, plain.jcfg, jnp.asarray(plain.enc), ids))
    out = generation.detect_language(plain.params, plain.cfg,
                                     torch.from_numpy(plain.enc), ids)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.dtype == torch.int32 and set(out.tolist()) <= set(ids)


def test_sampled_decode_is_one_draw_a_seed(plain, plain_tokens):
    gen = dict(max_new_tokens=12, temperature=1.3, top_k=20, top_p=0.95)
    a, _ = plain.port(seed=1, **gen)
    b, _ = plain.port(seed=1, **gen)
    c, _ = plain.port(seed=2, **gen)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, plain_tokens[0])
    for t in (a, c):
        assert (t[:, 1] == 11).all()            # the forced prefix holds
        assert not np.isin(t[:, 1:], [5, 7]).any()   # suppressed ids


@pytest.mark.parametrize("gen", [dict(top_k=1, temperature=0.7),
                                 dict(top_p=1e-4, temperature=1.5)],
                         ids=["top-k-1", "tiny-top-p"])
def test_sampling_with_one_token_left_is_greedy(plain, plain_tokens, gen):
    toks, lens = plain.port(max_new_tokens=12, seed=4, **gen)
    np.testing.assert_array_equal(toks, plain_tokens[0])
    np.testing.assert_array_equal(lens, plain_tokens[1])


def test_session_takes_every_non_beam_field(plain):
    """The session's greedy pipeline takes any GenerationConfig; with
    ``num_beams=2`` the same fields run the beam branch."""
    gen = torch_config.GenerationConfig(
        max_new_tokens=5, temperature=0.9, top_k=4, top_p=0.9,
        repetition_penalty=1.1, presence_penalty=0.2, min_new_tokens=1,
        bad_words=((13,),), stop_words=((10, 6),), return_timestamps=True,
        seed=3, kv_cache_dtype="int8", cross_kv_layout="bhdt")
    rt = torch_config.RuntimeConfig(donate_caches=False)
    session = WhisperSession(plain.params, plain.cfg, gen, rt, device="cpu")
    mel = np.random.default_rng(2).standard_normal(
        (2, 2 * plain.cfg.max_source_positions, plain.cfg.num_mel_bins))
    toks, lens = session.transcribe_features(mel.astype(np.float32))
    assert toks.shape == (2, 6) and (lens <= 6).all()
    beams = WhisperSession(plain.params, plain.cfg,
                           dataclasses.replace(gen, num_beams=2), rt,
                           device="cpu")
    toks, lens = beams.transcribe_features(mel.astype(np.float32))
    assert toks.shape == (2, 6) and (lens <= 6).all()


# -- the graph cache's bookkeeping (no capture on the CPU) ------------------

def _tree():
    return {"decoder": {"a": torch.zeros(2), "b": {"c": torch.ones(3)}}}


def _entry(params):
    leaves = generation._decoder_leaves(params)
    return generation._StepGraph(None, None, None, leaves), leaves


@pytest.fixture
def graphs():
    generation.drop_graphs()
    yield generation._GRAPHS
    generation.drop_graphs()


def test_an_entry_replays_only_against_its_own_weights(graphs):
    p = _tree()
    e, leaves = _entry(p)
    generation._store(("k",), e, leaves)
    assert generation._graph_entry(("k",), generation._decoder_leaves(p)) is e
    other = generation._decoder_leaves(_tree())
    assert generation._graph_entry(("k",), other) is None
    assert ("k",) not in graphs


def test_an_entry_goes_when_a_weight_it_reads_dies(graphs):
    p = _tree()
    e, leaves = _entry(p)
    generation._store(("k",), e, leaves)
    del leaves
    p["decoder"]["b"]["c"] = torch.ones(3)
    gc.collect()
    assert ("k",) not in graphs


def test_an_entry_goes_with_its_weights_without_a_collection(graphs):
    """Walking the weights leaves no reference cycle behind: the entry goes
    the moment its weights do, not at a later garbage collection (which,
    during a capture, would destroy its graph mid-capture)."""
    p = _tree()
    e, leaves = _entry(p)
    generation._store(("k",), e, leaves)
    ref = weakref.ref(p["decoder"]["b"]["c"])
    collecting = gc.isenabled()
    gc.disable()
    try:
        del e, leaves, p
        assert ref() is None and ("k",) not in graphs
    finally:
        if collecting:
            gc.enable()


def test_drop_graphs_and_refit_drop_the_old_weights_entries(graphs, plain):
    p, q = _tree(), _tree()
    for key, tree in (("p",), p), (("q",), q):
        e, leaves = _entry(tree)
        generation._store(key, e, leaves)
    assert generation.drop_graphs(p) == 1 and list(graphs) == [("q",)]
    session = WhisperSession(plain.params, plain.cfg, device="cpu")
    e, leaves = _entry(session.params)
    generation._store(("s",), e, leaves)
    session.refit(plain.ref)
    assert ("s",) not in graphs and ("q",) in graphs


def test_the_cache_keeps_the_latest_entries(graphs):
    trees = [_tree() for _ in range(generation.GRAPH_CACHE_SIZE + 2)]
    for i, tree in enumerate(trees):
        e, leaves = _entry(tree)
        generation._store((i,), e, leaves)
    assert list(graphs) == [(i,) for i in range(2, len(trees))]
