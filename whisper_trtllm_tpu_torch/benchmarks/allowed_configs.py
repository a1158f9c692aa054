"""Named benchmark configurations of the causal-LM zoo (counterpart of
``whisper_trtllm_tpu/benchmarks/allowed_configs.py``): every name of the
JAX registry with its architecture and its per-run limits (max batch,
input and output lengths).

``build_model`` builds every family of the registry: gpt, opt, llama,
gptj, gptneox, chatglm6b and bert (every name of theirs, ``gpt_175b``'s
width of 12288 and ``opt_66b``'s 9216 within K5's limit of 16384, GPT-J's
head dim of 256 within K1's and K2's), and bloom, which has no entry here,
as in the JAX registry. BERT is encoder-only: its ``generate`` is None, as
in the JAX registry.

``fits_one_v5e`` is the JAX registry's field (whether bf16 weights fit a
16 GB TPU v5e), kept so the two registries read alike; the H100 here has
80 GB.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PORTED_FAMILIES = ("gpt", "opt", "llama", "gptj", "gptneox", "bloom",
                   "chatglm6b", "bert")


@dataclass(frozen=True)
class BenchConfig:
    family: str                      # whisper_trtllm_tpu_torch.models.<family>
    model_kwargs: dict = field(default_factory=dict)
    max_batch_size: int = 256
    max_input_len: int = 512
    max_output_len: int = 200
    fits_one_v5e: bool = True


ALLOWED_CONFIGS: dict[str, BenchConfig] = {
    "gpt_350m": BenchConfig(
        family="gpt",
        model_kwargs=dict(n_layer=24, n_head=16, d_model=1024,
                          ffn_dim=4096, vocab_size=51200, n_positions=1024),
        max_batch_size=256, max_input_len=512, max_output_len=200,
    ),
    "gpt_175b": BenchConfig(
        family="gpt",
        model_kwargs=dict(n_layer=96, n_head=96, d_model=12288,
                          ffn_dim=49152, vocab_size=51200, n_positions=2048),
        max_batch_size=64, fits_one_v5e=False,
    ),
    "opt_350m": BenchConfig(
        family="opt",
        model_kwargs=dict(n_layer=24, n_head=16, d_model=1024,
                          ffn_dim=4096, vocab_size=50272, max_positions=2048),
    ),
    "opt_66b": BenchConfig(
        family="opt",
        model_kwargs=dict(n_layer=64, n_head=72, d_model=9216,
                          ffn_dim=36864, vocab_size=50272,
                          max_positions=2048),
        max_batch_size=64, fits_one_v5e=False,
    ),
    "llama_7b": BenchConfig(
        family="llama",
        model_kwargs=dict(n_layer=32, n_head=32, n_kv_head=32, d_model=4096,
                          ffn_dim=11008, vocab_size=32000,
                          max_positions=2048),
        max_batch_size=128,
    ),
    "llama_30b": BenchConfig(
        family="llama",
        model_kwargs=dict(n_layer=60, n_head=52, n_kv_head=52, d_model=6656,
                          ffn_dim=17920, vocab_size=32000,
                          max_positions=2048),
        max_batch_size=64, fits_one_v5e=False,
    ),
    "gptj_6b": BenchConfig(
        family="gptj",
        model_kwargs=dict(n_layer=28, n_head=16, d_model=4096,
                          ffn_dim=16384, rotary_dim=64, vocab_size=50401,
                          max_positions=2048),
        max_batch_size=64,
    ),
    "gptneox_20b": BenchConfig(
        family="gptneox",
        model_kwargs=dict(n_layer=44, n_head=64, d_model=6144,
                          ffn_dim=24576, rotary_pct=0.25, vocab_size=50432,
                          max_positions=2048),
        max_batch_size=16, fits_one_v5e=False,
    ),
    "chatglm_6b": BenchConfig(
        family="chatglm6b",
        model_kwargs=dict(n_layer=28, n_head=32, d_model=4096,
                          ffn_dim=16384, vocab_size=130528,
                          max_positions=2048),
        max_batch_size=64,
    ),
    "bert_base": BenchConfig(
        family="bert",
        model_kwargs=dict(n_layer=12, n_head=12, d_model=768, ffn_dim=3072,
                          vocab_size=30522, max_position_embeddings=512),
        max_input_len=512, max_output_len=0,
    ),
    "bert_large": BenchConfig(
        family="bert",
        model_kwargs=dict(n_layer=24, n_head=16, d_model=1024, ffn_dim=4096,
                          vocab_size=30522, max_position_embeddings=512),
        max_input_len=512, max_output_len=0,
    ),
    # dev-scale entries (not in the reference): tiny widths for tests
    "gpt_tiny": BenchConfig(
        family="gpt",
        model_kwargs=dict(n_layer=2, n_head=4, d_model=64, ffn_dim=128,
                          vocab_size=512, n_positions=256),
        max_batch_size=8, max_input_len=32, max_output_len=32,
    ),
    "bert_tiny": BenchConfig(
        family="bert",
        model_kwargs=dict(n_layer=2, n_head=4, d_model=64, ffn_dim=128,
                          vocab_size=512, max_position_embeddings=128),
        max_input_len=64, max_output_len=0,
    ),
}

_CFG_CLS = {"gpt": "GPTConfig", "opt": "OPTConfig", "llama": "LlamaConfig",
            "gptj": "GPTJConfig", "gptneox": "GPTNeoXConfig",
            "bloom": "BloomConfig", "chatglm6b": "ChatGLM6BConfig",
            "bert": "BertConfig"}


def family_module(fam: str):
    """The port's module of a zoo family; a family not ported yet raises
    ``NotImplementedError``."""
    if fam not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {fam!r} family is not ported yet (ROADMAP Queue 1 item "
            f"11); the port has {', '.join(PORTED_FAMILIES)}")
    import importlib

    return importlib.import_module(f"whisper_trtllm_tpu_torch.models.{fam}")


def config_class(fam: str):
    return getattr(family_module(fam), _CFG_CLS[fam])


def build_model(name: str):
    """name → (family, config, init_params, generate or None for the
    encoder-only BERT, forward)."""
    entry = ALLOWED_CONFIGS[name]
    mod = family_module(entry.family)
    cfg = config_class(entry.family)(**entry.model_kwargs)
    return (entry.family, cfg, mod.init_params, getattr(mod, "generate", None),
            mod.forward)
