"""PyTorch port: the sampling and word-rule processors against the JAX
package's (``whisper_trtllm_tpu/runtime/sampling.py``), elementwise on the
same random logits and token buffers drawn from a numpy seed; the cases of
``tests/test_sampling.py`` and ``tests/test_sampling_words.py``.

Tolerances: 1e-6 absolute on logits a processor keeps (the same fp32
arithmetic: a division, a product or a subtraction of one constant) and
equality of every banned (-1e9) position. The categorical draw cannot be
held to JAX's (its threefry stream is not reproduced), so it is held to
distribution properties: the support of top-k and top-p, one draw a seed,
another with another seed, and frequencies within 0.03 of the softmax over
4000 draws (about 4 standard deviations of the largest probability's
sampling error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_trtllm_tpu.runtime import sampling as jax_sampling
from whisper_trtllm_tpu_torch.runtime import sampling

ATOL = 1e-6


def _close(ours: torch.Tensor, theirs) -> None:
    ours, theirs = ours.numpy(), np.asarray(theirs)
    np.testing.assert_array_equal(ours <= -5e8, theirs <= -5e8)
    keep = theirs > -5e8
    np.testing.assert_allclose(ours[keep], theirs[keep], atol=ATOL, rtol=0)


def _logits(rng, b, v, scale=1.0):
    return (rng.standard_normal((b, v)) * scale).astype(np.float32)


def _buffer(rng, b, max_len, v):
    return rng.integers(0, v, size=(b, max_len)).astype(np.int32)


@pytest.mark.parametrize("temperature", [1.0, 0.7, 1.5, 0.0])
def test_temperature_matches_jax(rng, temperature):
    x = _logits(rng, 3, 40)
    _close(sampling.apply_temperature(torch.from_numpy(x), temperature),
           jax_sampling.apply_temperature(jnp.asarray(x), temperature))


@pytest.mark.parametrize("penalty", [1.0, 1.3, 0.8])
@pytest.mark.parametrize("per_lane", [False, True])
def test_repetition_penalty_matches_jax(rng, penalty, per_lane):
    x, buf = _logits(rng, 4, 30), _buffer(rng, 4, 9, 30)
    pos = np.asarray([0, 3, 8, 5], np.int32) if per_lane else np.int32(4)
    _close(sampling.apply_repetition_penalty(
        torch.from_numpy(x), torch.from_numpy(buf), torch.as_tensor(pos),
        penalty),
        jax_sampling.apply_repetition_penalty(
            jnp.asarray(x), jnp.asarray(buf), jnp.asarray(pos), penalty))


@pytest.mark.parametrize("k", [0, 1, 5, 20])
def test_top_k_matches_jax(rng, k):
    x = _logits(rng, 3, 50)
    _close(sampling.top_k_filter(torch.from_numpy(x), k),
           jax_sampling.top_k_filter(jnp.asarray(x), k))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.8, 0.95, 1.0])
def test_top_p_matches_jax(rng, p):
    x = _logits(rng, 4, 40, scale=2.0)
    _close(sampling.top_p_filter(torch.from_numpy(x), p),
           jax_sampling.top_p_filter(jnp.asarray(x), p))


@pytest.mark.parametrize("per_lane", [False, True])
def test_presence_penalty_matches_jax(rng, per_lane):
    x, buf = _logits(rng, 3, 12), _buffer(rng, 3, 6, 12)
    pos = np.asarray([2, 0, 5], np.int32) if per_lane else np.int32(2)
    _close(sampling.apply_presence_penalty(
        torch.from_numpy(x), torch.from_numpy(buf), torch.as_tensor(pos), 1.5),
        jax_sampling.apply_presence_penalty(
            jnp.asarray(x), jnp.asarray(buf), jnp.asarray(pos), 1.5))


def test_presence_penalty_subtracts_once(rng):
    x = _logits(rng, 2, 12)
    buf = np.zeros((2, 6), np.int32)
    buf[0, :3] = [4, 4, 5]
    buf[1, :3] = [1, 2, 3]
    out = sampling.apply_presence_penalty(
        torch.from_numpy(x), torch.from_numpy(buf), torch.tensor(2), 1.5
    ).numpy()
    np.testing.assert_allclose(out[0, 4], x[0, 4] - 1.5, atol=ATOL)
    np.testing.assert_allclose(out[0, 6:], x[0, 6:], atol=ATOL)


@pytest.mark.parametrize("gen_count", [0, 2, 4, 5, 9, [0, 3, 5]])
def test_min_new_tokens_matches_jax(rng, gen_count):
    x = _logits(rng, 3, 20)
    count = np.asarray(gen_count, np.int32)
    _close(sampling.apply_min_new_tokens(torch.from_numpy(x),
                                         torch.as_tensor(count), 5, 7),
           jax_sampling.apply_min_new_tokens(jnp.asarray(x),
                                             jnp.asarray(count), 5, 7))


def test_min_new_tokens_off_and_a_negative_eos(rng):
    x = torch.from_numpy(_logits(rng, 2, 10))
    assert sampling.apply_min_new_tokens(x, torch.tensor(0), 0, 3) is x
    _close(sampling.apply_min_new_tokens(x, torch.tensor(1), 4, -1),
           jax_sampling.apply_min_new_tokens(jnp.asarray(x.numpy()),
                                             jnp.int32(1), 4, -1))


def test_pad_word_list_matches_jax():
    words = [[5], [7, 8], [1, 2, 3]]
    for ours, theirs in zip(sampling.pad_word_list(words),
                            jax_sampling.pad_word_list(words)):
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError):
        sampling.pad_word_list([])
    with pytest.raises(ValueError):
        sampling.pad_word_list([[1], []])


_BAD = [[5], [7, 8], [1, 2, 3]]
_BAD_HISTS = [
    np.asarray([[0, 9, 7], [4, 1, 2]], np.int32),   # bans 8; bans 3
    np.asarray([[6, 6, 6], [7, 8, 7]], np.int32),   # -; bans 8
]


@pytest.mark.parametrize("hist", range(len(_BAD_HISTS)))
@pytest.mark.parametrize("as_tensors", [False, True])
def test_ban_bad_words_matches_jax(rng, hist, as_tensors):
    x = _logits(rng, 2, 15)
    buf = np.full((2, 8), 11, np.int32)
    buf[:, :3] = _BAD_HISTS[hist]
    words = (sampling.word_table(_BAD, "cpu") if as_tensors
             else sampling.pad_word_list(_BAD))
    _close(sampling.ban_bad_words(torch.from_numpy(x), torch.from_numpy(buf),
                                  torch.tensor(2, dtype=torch.int32), words),
           jax_sampling.ban_bad_words(jnp.asarray(x), jnp.asarray(buf),
                                      jnp.int32(2),
                                      jax_sampling.pad_word_list(_BAD)))


@pytest.mark.parametrize("pos", [0, 1, 4, [0, 2, 5, 7]])
def test_ban_bad_words_on_random_buffers_matches_jax(rng, pos):
    """A small vocabulary, so that prefixes match often; context shorter
    than a prefix never matches."""
    words = [[2], [3, 1], [0, 1, 2], [4, 4, 4, 4]]
    x, buf = _logits(rng, 4, 6), _buffer(rng, 4, 8, 6)
    p = np.asarray(pos, np.int32)
    _close(sampling.ban_bad_words(
        torch.from_numpy(x), torch.from_numpy(buf), torch.as_tensor(p),
        sampling.pad_word_list(words)),
        jax_sampling.ban_bad_words(jnp.asarray(x), jnp.asarray(buf),
                                   jnp.asarray(p),
                                   jax_sampling.pad_word_list(words)))


def test_ban_bad_words_short_context():
    out = sampling.ban_bad_words(
        torch.zeros((1, 10)), torch.tensor([[1, 2, 0, 0]]), torch.tensor(0),
        sampling.pad_word_list([[2, 1, 2, 3]]))
    assert (out > -5e8).all()


def test_match_stop_words_matches_jax(rng):
    words = sampling.pad_word_list([[4, 5], [9]])
    buf = np.asarray([[1, 4, 5, 0], [4, 5, 6, 0], [2, 3, 9, 0]], np.int32)
    cases = [(buf, np.int32(2)), (buf, np.asarray([2, 1, 1], np.int32)),
             (buf[:, :1], np.int32(0))]
    for b, pos in cases:
        ours = sampling.match_stop_words(torch.from_numpy(b),
                                         torch.as_tensor(pos), words)
        theirs = jax_sampling.match_stop_words(jnp.asarray(b),
                                               jnp.asarray(pos), words)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(
        sampling.match_stop_words(torch.from_numpy(buf), torch.tensor(2),
                                  words).numpy(), [True, False, True])
    rand = _buffer(rng, 6, 7, 10)
    for pos in range(7):
        np.testing.assert_array_equal(
            sampling.match_stop_words(torch.from_numpy(rand),
                                      torch.tensor(pos), words).numpy(),
            np.asarray(jax_sampling.match_stop_words(
                jnp.asarray(rand), jnp.int32(pos), words)))


def test_sample_token_greedy_paths_match_jax(rng):
    """Neutral knobs: the argmax; a repetition penalty alone: the
    penalized argmax, deterministic as in the JAX package."""
    x, buf = _logits(rng, 5, 20), _buffer(rng, 5, 6, 20)
    key = jax.random.PRNGKey(0)
    np.testing.assert_array_equal(
        sampling.sample_token(torch.from_numpy(x)).numpy(), x.argmax(-1))
    ours = sampling.sample_token(torch.from_numpy(x),
                                 tokens=torch.from_numpy(buf),
                                 pos=torch.tensor(3), repetition_penalty=1.7)
    theirs = jax_sampling.sample_token(key, jnp.asarray(x),
                                       tokens=jnp.asarray(buf),
                                       pos=jnp.int32(3),
                                       repetition_penalty=1.7)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ours.dtype == torch.int32


def test_sample_token_draws_inside_the_top_k(rng):
    x = _logits(rng, 2, 20)
    top3 = np.argsort(x, axis=-1)[:, -3:]
    for pos in range(40):
        out = sampling.sample_token(torch.from_numpy(x), temperature=1.5,
                                    top_k=3, pos=torch.tensor(pos)).numpy()
        for b in range(2):
            assert out[b] in top3[b]


def test_sample_token_draws_inside_the_nucleus(rng):
    x = _logits(rng, 3, 30, scale=2.0)
    kept = np.asarray(jax_sampling.top_p_filter(jnp.asarray(x), 0.6)) > -5e8
    seen = np.zeros_like(kept)
    for pos in range(200):
        out = sampling.sample_token(torch.from_numpy(x), top_p=0.6,
                                    pos=torch.tensor(pos), seed=3).numpy()
        seen[np.arange(3), out] = True
    assert not (seen & ~kept).any()
    # more than one kept token is drawn in a row that keeps several
    assert (seen.sum(1)[kept.sum(1) > 1] > 1).all()


def test_sample_token_is_one_draw_a_seed_and_position():
    x = torch.zeros((4, 50))
    a = sampling.sample_token(x, temperature=1.0, do_sample=True,
                              pos=torch.tensor(7), seed=11)
    b = sampling.sample_token(x, temperature=1.0, do_sample=True,
                              pos=torch.tensor(7), seed=11)
    c = sampling.sample_token(x, temperature=1.0, do_sample=True,
                              pos=torch.tensor(7), seed=12)
    d = sampling.sample_token(x, temperature=1.0, do_sample=True,
                              pos=torch.tensor(8), seed=11)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    # the lanes draw apart
    assert len(set(a.tolist())) > 1


def test_sample_token_frequencies_follow_the_softmax():
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0, 1.5, 0.2]])
    want = torch.softmax(logits, -1)[0].numpy()
    counts = np.zeros(8)
    for pos in range(4000):
        counts[int(sampling.sample_token(logits, do_sample=True,
                                         pos=torch.tensor(pos), seed=5))] += 1
    np.testing.assert_allclose(counts / counts.sum(), want, atol=0.03)


def test_gumbel_noise_is_a_pure_function_of_its_counters():
    g = sampling.gumbel_noise(3, torch.tensor(5, dtype=torch.int32), 4, 100,
                              "cpu")
    assert g.shape == (4, 100) and g.dtype == torch.float32
    assert torch.isfinite(g).all()
    assert torch.equal(g, sampling.gumbel_noise(3, 5, 4, 100, "cpu"))
    assert not torch.equal(g, sampling.gumbel_noise(4, 5, 4, 100, "cpu"))
    # standard Gumbel: mean ~ 0.5772, over 400 values within 0.2
    assert abs(float(g.mean()) - 0.5772) < 0.2
