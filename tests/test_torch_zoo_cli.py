"""PyTorch port: the zoo's entry points on the CPU.

- ``cli/run_zoo.py --cpu`` prints the JAX CLI's (``cli/run_zoo.py``)
  tokens: on a tiny HF GPT-2, GPT-J and Bloom saved to local
  directories, and on each family's testing-width random weights;
  ``--hf-model`` refuses ChatGLM-6B with the JAX CLI's message.
- ``benchmarks/benchmark.py::bench_zoo``, with the registry holding one
  tiny gpt entry (and one tiny chatglm6b entry), returns finite rows (fp32
  and bf16, float and weight-only int8 weights).
- ``cli/run_zoo.py --config`` refuses BERT's names with the JAX CLI's
  message (the encoder has no ``generate``), and ``--quant sq`` raises
  naming ROADMAP Queue 1 item 11.
"""

import json
import math
import runpy
import sys

import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu_torch.benchmarks import allowed_configs, benchmark
from whisper_trtllm_tpu_torch.cli import run_zoo


def _jax_cli(argv, capsys) -> dict:
    old = sys.argv
    sys.argv = ["run_zoo"] + argv
    try:
        runpy.run_module("cli.run_zoo", run_name="__main__")
    finally:
        sys.argv = old
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_cli(argv, capsys) -> dict:
    run_zoo.main(argv + ["--cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_zoo_on_a_local_hf_gpt2_prints_the_jax_clis_tokens(tmp_path,
                                                              capsys):
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    GPT2LMHeadModel(GPT2Config(
        vocab_size=89, n_positions=32, n_embd=32, n_layer=2, n_head=4,
        eos_token_id=2, bos_token_id=1)).save_pretrained(tmp_path / "hf")
    argv = ["--family", "gpt", "--hf-model", str(tmp_path / "hf"),
            "--prompt-ids", "3", "4", "5", "--max-new-tokens", "8"]
    row = _port_cli(argv, capsys)
    assert row == _jax_cli(argv, capsys)
    assert len(row["output_ids"]) == 11


def test_run_zoo_on_a_local_hf_gptj_prints_the_jax_clis_tokens(tmp_path,
                                                              capsys):
    from transformers import GPTJConfig, GPTJForCausalLM

    torch.manual_seed(0)
    GPTJForCausalLM(GPTJConfig(
        vocab_size=89, n_positions=32, n_embd=32, n_layer=2, n_head=4,
        rotary_dim=4, eos_token_id=2, bos_token_id=1)).save_pretrained(
            tmp_path / "hf")
    argv = ["--family", "gptj", "--hf-model", str(tmp_path / "hf"),
            "--prompt-ids", "3", "4", "5", "--max-new-tokens", "8"]
    row = _port_cli(argv, capsys)
    assert row == _jax_cli(argv, capsys)
    assert row["family"] == "gptj" and len(row["output_ids"]) == 11


def test_run_zoo_on_a_local_hf_bloom_prints_the_jax_clis_tokens(tmp_path,
                                                               capsys):
    from transformers import BloomConfig, BloomForCausalLM

    torch.manual_seed(0)
    BloomForCausalLM(BloomConfig(
        vocab_size=89, hidden_size=32, n_layer=2, n_head=4, eos_token_id=2,
        bos_token_id=1)).save_pretrained(tmp_path / "hf")
    argv = ["--family", "bloom", "--hf-model", str(tmp_path / "hf"),
            "--prompt-ids", "3", "4", "5", "--max-new-tokens", "8"]
    row = _port_cli(argv, capsys)
    assert row == _jax_cli(argv, capsys)
    assert row["family"] == "bloom" and len(row["output_ids"]) == 11


def test_run_zoo_refuses_an_hf_chatglm6b_as_the_jax_cli_does(tmp_path):
    argv = ["--family", "chatglm6b", "--hf-model", str(tmp_path),
            "--prompt-ids", "3", "4"]
    with pytest.raises(SystemExit, match="trust_remote_code") as port:
        run_zoo.main(argv + ["--cpu"])
    old = sys.argv
    sys.argv = ["run_zoo"] + argv
    try:
        with pytest.raises(SystemExit) as jax_cli:
            runpy.run_module("cli.run_zoo", run_name="__main__")
    finally:
        sys.argv = old
    assert str(port.value) == str(jax_cli.value)


@pytest.mark.parametrize("family", ["gpt", "opt", "llama", "gptj",
                                    "gptneox", "bloom", "chatglm6b"])
def test_run_zoo_testing_weights_print_the_jax_clis_tokens(family, capsys):
    argv = ["--family", family, "--prompt-ids", "5", "9", "12",
            "--max-new-tokens", "6", "--repetition-penalty", "1.2"]
    assert _port_cli(argv, capsys) == _jax_cli(argv, capsys)


@pytest.mark.parametrize("argv", [
    ["--config", "bert_tiny"], ["--config", "bert_large"],
    ["--config", "bert_base"]])
def test_run_zoo_refuses_the_families_not_ported(argv):
    """BERT is ported, but encoder-only: the CLI refuses it as the JAX
    CLI does, before drawing any weight."""
    with pytest.raises(SystemExit, match="encoder-only"):
        run_zoo.main(argv + ["--prompt-ids", "3", "--cpu"])


@pytest.fixture
def tiny_registry(monkeypatch):
    entry = allowed_configs.BenchConfig(
        family="gpt",
        model_kwargs=dict(n_layer=2, n_head=4, d_model=32, ffn_dim=64,
                          vocab_size=97, n_positions=64),
        max_batch_size=4, max_input_len=8, max_output_len=6)
    monkeypatch.setattr(allowed_configs, "ALLOWED_CONFIGS",
                        {"gpt_test": entry})
    monkeypatch.setattr(benchmark, "ALLOWED_CONFIGS", {"gpt_test": entry})


@pytest.mark.parametrize("dtype,quant", [("float32", None),
                                         ("bfloat16", None),
                                         ("float32", "int8")])
def test_bench_zoo_on_the_cpu_returns_a_finite_row(tiny_registry, dtype,
                                                   quant):
    # batch, input and output lengths are cut to the entry's limits
    row = benchmark.bench_zoo("gpt_test", batch=8, in_len=12, out_len=10,
                              dtype=dtype, iters=2, quant=quant,
                              device="cpu")
    assert (row["batch"], row["input_len"], row["output_len"]) == (4, 8, 6)
    assert row["family"] == "gpt" and row["quant"] == quant
    assert row["backend"] == "cpu" and row["device"] is None
    for key in ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
                "tokens_per_s"):
        assert math.isfinite(row[key]) and row[key] > 0, key
    assert row["launches"] == {}  # the plain versions launch nothing


def test_bench_zoo_runs_chatglm_through_its_own_generate(monkeypatch):
    """A tiny chatglm6b entry: GLM's ``generate`` (its [gMASK] position
    defaulted) takes bench_zoo's call as the other families' do."""
    entry = allowed_configs.BenchConfig(
        family="chatglm6b",
        model_kwargs=dict(n_layer=2, n_head=4, d_model=32, ffn_dim=64,
                          vocab_size=97, max_positions=64),
        max_batch_size=4, max_input_len=8, max_output_len=6)
    monkeypatch.setattr(allowed_configs, "ALLOWED_CONFIGS",
                        {"glm_test": entry})
    monkeypatch.setattr(benchmark, "ALLOWED_CONFIGS", {"glm_test": entry})
    row = benchmark.bench_zoo("glm_test", batch=2, in_len=5, out_len=4,
                              dtype="float32", iters=2, device="cpu")
    assert row["family"] == "chatglm6b" and row["output_len"] == 4
    assert math.isfinite(row["tokens_per_s"]) and row["tokens_per_s"] > 0


def test_chatglm_6b_builds_without_drawing_weights(monkeypatch):
    from whisper_trtllm_tpu_torch.models.chatglm6b import model as glm

    def refuse(*args, **kwargs):
        raise AssertionError("build_model drew weights")

    monkeypatch.setattr(glm.np.random, "default_rng", refuse)
    fam, cfg, init_params, generate, forward = allowed_configs.build_model(
        "chatglm_6b")
    assert fam == "chatglm6b" and init_params is glm.init_params
    assert (cfg.d_model, cfg.n_head, cfg.head_dim, cfg.vocab_size) == (
        4096, 32, 128, 130528)
    assert generate is glm.generate and forward is glm.forward


@pytest.mark.parametrize("name,quant", [("bert_tiny", "sq"),
                                        ("bert_large", "sq"),
                                        ("bert_base", "sq"),
                                        ("gpt_350m", "sq")])
def test_bench_zoo_refuses_what_is_not_ported(name, quant):
    with pytest.raises(NotImplementedError, match="item 11"):
        benchmark.bench_zoo(name, 1, 4, 2, "float32", 1, quant=quant,
                            device="cpu")
