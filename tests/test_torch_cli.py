"""PyTorch port: the Whisper CLIs (``whisper_trtllm_tpu_torch/cli``)
against the JAX package's, in process, on the CPU (``--cpu``).

- ``transcribe``: the printed ids equal JAX's ``cli.transcribe`` on a
  shared checkpoint (``WhisperConfig.testing()``, JAX's seed-0 tree) over
  a dataset pickle (one mel stored (M, T), a tail batch padded) and over
  the synthetic mels.
- ``cal_wer`` and ``accept`` with ``tests/test_accept_cli.py``'s fake
  tokenizer and tiny HF model: JAX's WER line and report (the bf16 drift
  keys are only checked present: bf16 rounds at other places in the two
  frameworks), the gates passing on the HF transcripts and exit 1 on bad
  references.
- ``build`` on that tiny local HF directory writes a checkpoint byte-equal
  to the JAX CLI's; ``warm_cache --cpu`` prints JAX's ``warmed`` lines;
  ``visualize --cpu`` writes the two exported graphs and the operator
  list.
- ``synthetic_asr``'s toy acceptance loop (make, finetune 1 epoch,
  export-hf, accept) ends with ``differential_frac`` 1.0, and its
  ``make`` writes JAX's checkpoint, tokens and eval audio (its mels within
  the JAX frontend's tolerance).
"""

import json
import os
import pickle
import re
import sys

import numpy as np
import pytest

from test_accept_cli import _FakeTok, dataset, hf_dir  # noqa: F401
from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.config import WhisperConfig
from whisper_trtllm_tpu.models.whisper import init_params
from whisper_trtllm_tpu.utils.checkpoint import save_checkpoint
from whisper_trtllm_tpu_torch.cli import (
    accept,
    build,
    cal_wer,
    synthetic_asr,
    transcribe,
    visualize,
    warm_cache,
)

# the JAX frontend's tolerance on log10-mel values (fp32 DFT sums in
# another order, amplified by log10 near the floor)
MEL_ATOL = 2e-4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny-test"
    cfg = WhisperConfig.testing()
    save_checkpoint(str(path), init_params(cfg, 0), cfg)
    return str(path), cfg


@pytest.fixture(scope="module")
def mel_dataset(checkpoint, tmp_path_factory):
    _, cfg = checkpoint
    rng = np.random.default_rng(3)
    mels = rng.standard_normal(
        (3, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)
    items = [(mels[0], "a"), (mels[1].T.copy(), "b"), (mels[2], "c")]
    path = tmp_path_factory.mktemp("ds") / "ds.pkl"
    with open(path, "wb") as f:
        pickle.dump(items, f)
    return str(path)


@pytest.fixture
def fake_tokenizer(monkeypatch):
    import transformers

    monkeypatch.setattr(transformers.WhisperTokenizerFast, "from_pretrained",
                        classmethod(lambda cls, p, **kw: _FakeTok()))


def _jax_main(module, argv, monkeypatch):
    """A JAX CLI's ``main()``, which reads ``sys.argv``."""
    import importlib

    monkeypatch.setattr(sys, "argv", [module] + argv)
    return importlib.import_module(f"cli.{module}").main()


def _hypotheses(out: str) -> list:
    return [line for line in out.splitlines() if re.match(r"\[\d+\] ", line)]


@pytest.mark.parametrize("use_dataset", [True, False],
                         ids=["dataset", "synthetic"])
def test_transcribe_prints_jax_ids(checkpoint, mel_dataset, monkeypatch,
                                   capsys, use_dataset):
    path, _ = checkpoint
    args = ["--checkpoint", path, "--batch", "2", "--max-new-tokens", "6"]
    if use_dataset:
        args += ["--dataset", mel_dataset]
    _jax_main("transcribe", args, monkeypatch)
    want = capsys.readouterr().out
    transcribe.main(args + ["--cpu"])
    got = capsys.readouterr().out
    n = 3 if use_dataset else 8
    assert f"{n} utterances in" in got and "audio-s/s" in got
    assert _hypotheses(got) == _hypotheses(want)
    assert len(_hypotheses(got)) == min(n, 5)


def test_cal_wer_prints_jax_wer(checkpoint, mel_dataset, fake_tokenizer,
                                monkeypatch, capsys):
    path, _ = checkpoint
    args = ["--checkpoint", path, "--dataset", mel_dataset, "--hf-model",
            "unused", "--batch", "2", "--max-new-tokens", "6"]
    _jax_main("cal_wer", args, monkeypatch)
    want = capsys.readouterr().out
    cal_wer.main(args + ["--cpu"])
    got = capsys.readouterr().out

    def wer(out):
        m = re.search(r"WER: ([0-9.]+)%  \((\d+) utterances", out)
        return m.groups()

    assert wer(got) == wer(want)


def _report(path):
    with open(path) as f:
        return json.load(f)


def test_accept_gives_jax_report_and_passes(hf_dir, dataset,  # noqa: F811
                                            fake_tokenizer, tmp_path):
    from cli import accept as jax_accept

    args = ["--hf-dir", hf_dir[0], "--dataset", dataset, "--batch", "2",
            "--max-new-tokens", "10", "--wer-threshold", "0.0",
            "--min-match-frac", "1.0", "--bf16-drift"]
    assert jax_accept.main(args + ["--out", str(tmp_path / "j.json")]) == 0
    assert accept.main(args + ["--out", str(tmp_path / "t.json"),
                               "--cpu"]) == 0
    got, want = _report(tmp_path / "t.json"), _report(tmp_path / "j.json")
    drift = {"bf16_token_agreement", "bf16_exact_text_matches",
             "bf16_wer_pct"}
    assert drift <= set(got) and 0.0 <= got["bf16_token_agreement"] <= 1.0
    skip = drift | {"audio_s_per_s"}
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert got["pass"] is True and got["differential_frac"] == 1.0
    assert got["wer_pct"] == 0.0


def test_accept_exits_1_on_bad_references(hf_dir, dataset,  # noqa: F811
                                          fake_tokenizer, tmp_path):
    with open(dataset, "rb") as f:
        data = pickle.load(f)
    bad = tmp_path / "bad.cache"
    with open(bad, "wb") as f:
        pickle.dump([(m, "qzz totally wrong words") for m, _ in data], f)
    rc = accept.main([
        "--hf-dir", hf_dir[0], "--dataset", str(bad), "--batch", "2",
        "--max-new-tokens", "10", "--wer-threshold", "1.0",
        "--skip-differential", "--cpu", "--out", str(tmp_path / "r.json"),
    ])
    assert rc == 1 and _report(tmp_path / "r.json")["pass"] is False


def test_build_writes_the_jax_checkpoint(hf_dir, tmp_path,  # noqa: F811
                                         monkeypatch, capsys):
    _jax_main("build", ["--model", hf_dir[0], "--output",
                        str(tmp_path / "jax"), "--warmup-batches"],
              monkeypatch)
    capsys.readouterr()
    build.main(["--model", hf_dir[0], "--output", str(tmp_path / "torch"),
                "--warmup-batches", "--cpu"])
    assert f"saved weights+config to {tmp_path / 'torch'}" in \
        capsys.readouterr().out
    for name in ("params.msgpack", "config.json"):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_warm_cache_prints_warmed_lines(checkpoint, capsys):
    path, _ = checkpoint
    warm_cache.main(["--checkpoint", path, "--batch", "1", "2",
                     "--gen-tokens", "3", "--dtype", "float32", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for b, line in zip((1, 2), lines):
        assert re.fullmatch(rf"warmed batch={b} tokens=3 beams=1 "
                            r"dtype=float32: \d+\.\ds", line), line


def test_visualize_writes_the_graphs(checkpoint, tmp_path, capsys):
    path, _ = checkpoint
    out = str(tmp_path / "graph")
    visualize.main(["--checkpoint", path, "--out", out, "--max-new-tokens",
                    "4", "--cpu"])
    encode_fx = open(out + ".encode.fx.txt").read()
    step_fx = open(out + ".step.fx.txt").read()
    kernels = open(out + ".kernels.txt").read().splitlines()
    assert "torch.ops.aten.conv1d" in encode_fx
    assert "torch.ops.aten.argmax" in step_fx and "index_copy" in step_fx
    assert kernels[1].startswith("# wrapper launches: flash_fwd 0")
    assert any(line.startswith("aten::") for line in kernels[3:])


@pytest.fixture(scope="module")
def toy_corpus(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth") / "synth")
    assert synthetic_asr.main(["make", "--out", out, "--preset", "toy",
                               "--train-n", "3", "--eval-n", "2",
                               "--cpu"]) == 0
    return out


def test_synthetic_make_writes_the_jax_corpus(toy_corpus, tmp_path):
    from cli import synthetic_asr as jax_synth

    jax_out = str(tmp_path / "jax")
    jax_synth.main(["make", "--out", jax_out, "--preset", "toy",
                    "--train-n", "3", "--eval-n", "2"])
    assert synthetic_asr.WORDS == jax_synth.WORDS
    for name in ("ckpt_init/params.msgpack", "ckpt_init/config.json",
                 "eval_wavs/utt0000.wav", "eval_wavs/utt0001.txt",
                 "hf/tokenizer.json"):
        with open(os.path.join(toy_corpus, name), "rb") as f, \
                open(os.path.join(jax_out, name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(toy_corpus, "train.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(jax_out, "train.pkl"), "rb") as f:
        want = pickle.load(f)
    assert [ids for _, ids in got] == [ids for _, ids in want]
    for (mel, _), (jmel, _) in zip(got, want):
        np.testing.assert_allclose(mel, jmel, atol=MEL_ATOL, rtol=0)


def test_synthetic_toy_loop_ends_with_an_exact_differential(toy_corpus,
                                                            tmp_path):
    from whisper_trtllm_tpu_torch.cli import finetune

    ft = str(tmp_path / "ckpt_ft")
    finetune.main(["--checkpoint", os.path.join(toy_corpus, "ckpt_init"),
                   "--dataset", os.path.join(toy_corpus, "train.pkl"),
                   "--output", ft, "--epochs", "1", "--batch", "3",
                   "--lr", "3e-4", "--max-target-len", "16", "--cpu"])
    assert synthetic_asr.main(["export-hf", "--checkpoint", ft, "--hf-dir",
                               os.path.join(toy_corpus, "hf"),
                               "--cpu"]) == 0
    rc = accept.main([
        "--hf-dir", os.path.join(toy_corpus, "hf"),
        "--audio-dir", os.path.join(toy_corpus, "eval_wavs"),
        "--max-new-tokens", "10", "--batch", "2", "--limit", "2",
        "--min-match-frac", "1.0", "--out", str(tmp_path / "accept.json"),
        "--cpu"])
    report = _report(tmp_path / "accept.json")
    # the same weights on both sides: exact, though the toy model is
    # untrained
    assert report["differential_frac"] == 1.0
    assert rc == 0
