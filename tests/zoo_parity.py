"""Shared by ``tests/test_torch_{gpt,opt,llama,gptj_gptneox,bloom}.py``: one zoo
family's JAX module and its port on the same weights (an HF model built from a tiny
config with a seed, converted by the JAX package and carried over by
``params_from_numpy``), and the JAX side's generate calls with any
sampling configuration (its ``causal_lm`` loop over the model's own
prefill and step, jitted)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from whisper_trtllm_tpu.runtime import causal_lm as jax_causal_lm
from whisper_trtllm_tpu_torch.runtime import causal_lm
from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

# forward against JAX's and HF's (fp32 sums in another order)
FORWARD_TOL = 1e-5
BEAM_SCORE_TOL = 1e-5

# the rule-bound configurations held token-equal to JAX
RULES = {
    "repetition": dict(repetition_penalty=1.3),
    "presence": dict(presence_penalty=0.5),
    "min_new": dict(min_new_tokens=5),
    "bad_words": dict(bad_words="trajectory"),
    "stop_words": dict(stop_words="trajectory"),
    "together": dict(repetition_penalty=1.2, min_new_tokens=3,
                     bad_words="trajectory"),
}


class Family:
    """The JAX module ``jmod`` and the port's ``tmod`` of one family, on the
    weights the JAX converter made from ``hf``."""

    def __init__(self, jmod, tmod, hf, converter: str, cfg_cls: str,
                 kv_heads: str = "n_head"):
        self.jmod, self.tmod, self.hf = jmod, tmod, hf
        self.jp, self.jcfg = getattr(jmod, converter)(hf)
        self.converter, self.kv_heads = converter, kv_heads
        self.cfg_cls = getattr(tmod, cfg_cls)
        self.cfg = self.port_cfg(self.jcfg)
        self.tp = params_from_numpy(self.jp, "cpu")

    def port_cfg(self, jcfg):
        return self.cfg_cls(**dataclasses.asdict(jcfg))

    def limit(self) -> int:
        """The position limit (none for ALiBi's Bloom)."""
        return getattr(self.jcfg, "n_positions", None) or \
            getattr(self.jcfg, "max_positions", None) or 1 << 30

    def prompt(self, seed: int, b: int, p: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(3, self.jcfg.vocab_size, (b, p)).astype(np.int32)

    def cache_shape(self, jcfg, b: int, max_len: int) -> tuple:
        return (jcfg.n_layer, b, getattr(jcfg, self.kv_heads), max_len,
                jcfg.head_dim)

    # -- the JAX side ------------------------------------------------------

    def jax_generate(self, prompt, max_new: int, sc=None, jcfg=None):
        jcfg = jcfg or self.jcfg
        m = self.jmod
        b, p = prompt.shape
        max_len = min(self.limit(), p + max_new)
        fn = jax.jit(lambda params, t: jax_causal_lm.generate_tokens(
            lambda pr, tk, ck, cv: m._prefill(pr, jcfg, tk, ck, cv),
            lambda pr, tok, pos, ck, cv: m._step(pr, jcfg, tok, pos, ck, cv),
            params, t, cache_shape=self.cache_shape(jcfg, b, max_len),
            prompt_len=p, max_len=max_len, eos_token_id=jcfg.eos_token_id,
            sampling_cfg=sc))
        return np.asarray(fn(self.jp, jnp.asarray(prompt)))

    def jax_generate_ragged(self, prompt, lens, max_new: int, sc=None,
                            jcfg=None):
        jcfg = jcfg or self.jcfg
        m = self.jmod
        b, p = prompt.shape
        fn = jax.jit(lambda params, t, ln: jax_causal_lm.generate_tokens_ragged(
            lambda pr, tk, l2, ck, cv: m._prefill_ragged(pr, jcfg, tk, l2, ck,
                                                         cv),
            lambda pr, tok, pos, ck, cv: m._step(pr, jcfg, tok, pos, ck, cv),
            params, t, ln, cache_shape=self.cache_shape(jcfg, b, p + max_new),
            max_new_tokens=max_new, eos_token_id=jcfg.eos_token_id,
            sampling_cfg=sc))
        return np.asarray(fn(self.jp, jnp.asarray(prompt),
                             jnp.asarray(lens, jnp.int32)))

    # -- the port ----------------------------------------------------------

    def generate(self, prompt, max_new: int, cfg=None, **kw):
        return self.tmod.generate(self.tp, cfg or self.cfg, prompt, max_new,
                                  device="cpu", **kw).numpy()

    def generate_ragged(self, prompt, lens, max_new: int, cfg=None, **kw):
        return self.tmod.generate_ragged(self.tp, cfg or self.cfg, prompt,
                                         lens, max_new, device="cpu",
                                         **kw).numpy()

    # -- shared checks -----------------------------------------------------

    def eos_from_trajectory(self, prompt, max_new: int, at: int = 3) -> int:
        """A token the greedy trajectory of lane 0 writes ``at`` steps in:
        taken as EOS, it ends lanes early (padding, and steps past the
        stop that write pad)."""
        out = self.generate(prompt, max_new)
        return int(out[0, prompt.shape[1] + at])

    def words(self, prompt, max_new: int):
        """A bad word and a stop word from lane 0's greedy trajectory: the
        one-token word it writes first, and the two-token word it writes
        at steps 2 and 3."""
        out = self.generate(prompt, max_new)
        p = prompt.shape[1]
        return [[int(out[0, p])]], [[int(out[0, p + 2]), int(out[0, p + 3])]]

    def rule_cfgs(self, rule: str, prompt, max_new: int):
        """(JAX sampling cfg, port sampling cfg, JAX config, port config)
        for one of ``RULES``: word lists taken from the trajectory, and for
        min-new-tokens an EOS the trajectory reaches."""
        kw = dict(RULES[rule])
        bad, stop = self.words(prompt, max_new)
        if kw.get("bad_words") == "trajectory":
            kw["bad_words"] = bad
        if kw.get("stop_words") == "trajectory":
            kw["stop_words"] = stop
        jcfg = self.jcfg
        if "min_new_tokens" in kw:
            jcfg = dataclasses.replace(
                jcfg, eos_token_id=self.eos_from_trajectory(prompt, max_new,
                                                            at=1))
        return (jax_causal_lm.make_sampling_cfg(**kw),
                causal_lm.make_sampling_cfg(**kw), jcfg,
                self.port_cfg(jcfg))

    def forward_errors(self, tokens):
        got = self.tmod.forward(self.tp, self.cfg, tokens).numpy()
        jax_out = np.asarray(self.jmod.forward(self.jp, self.jcfg, tokens))
        with torch.no_grad():
            hf_out = self.hf(torch.from_numpy(tokens.astype(np.int64))
                             ).logits.numpy()
        return np.abs(got - jax_out).max(), np.abs(got - hf_out).max()


def assert_trees_equal(got, want, path: str = "") -> None:
    """The port's tensor tree equals the JAX package's numpy tree, keys,
    list lengths, shapes and values bit for bit."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
        return
    assert set(got) == set(want), path
    for k, v in want.items():
        if isinstance(v, (dict, list)):
            assert_trees_equal(got[k], v, f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=f"{path}/{k}")


def check_sampling(fam: Family, prompt) -> None:
    """A sampled call gives one draw a seed and another with another seed
    (the port draws its own noise, so no draw equals JAX's); top-k 1 leaves
    the greedy token at every step."""
    kw = dict(temperature=1.3, top_k=8)
    a = fam.generate(prompt, 10, seed=7, **kw)
    np.testing.assert_array_equal(a, fam.generate(prompt, 10, seed=7, **kw))
    assert not np.array_equal(a, fam.generate(prompt, 10, seed=8, **kw))
    greedy = fam.generate(prompt, 10)
    np.testing.assert_array_equal(
        fam.generate(prompt, 10, seed=7, temperature=1.3, top_k=1), greedy)
    np.testing.assert_array_equal(greedy, fam.jax_generate(prompt, 10))
    lens = np.full(prompt.shape[0], prompt.shape[1], np.int32)
    r = fam.generate_ragged(prompt, lens, 10, seed=7, **kw)
    np.testing.assert_array_equal(
        r, fam.generate_ragged(prompt, lens, 10, seed=7, **kw))
    assert not np.array_equal(
        r, fam.generate_ragged(prompt, lens, 10, seed=8, **kw))


def assert_beams_match(got, want, tol: float) -> None:
    """Beam outputs (tokens, scores, lengths): tokens and lengths equal,
    scores within ``tol``."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=tol, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
