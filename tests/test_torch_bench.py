"""PyTorch port: the benchmarks package and the bench entry point on the
CPU.

- ``benchmarks/roofline.py`` equals the JAX package's module exactly, for
  every preset and over a grid of decode batches, cache lengths and byte
  widths; the card's peaks are keyed by its CUDA name.
- ``benchmarks/mem_monitor.py`` reads -1.0 on the CPU.
- The bench's timed pipeline (``cli/bench.py``'s session and pass) gives
  the JAX package's ``transcribe_tokens`` tokens exactly, in fp32, from the
  same ``init_params`` and inputs: float and int8 KV caches, int8 weights
  through the session's load-time chain, and audio through the frontend.
- The gate reruns the hardware check for a missing, failing or stale
  record and refuses what the rerun does not repair.
- Without a card both entry points exit non-zero and print no result;
  what is not ported raises ``NotImplementedError``.
"""

import dataclasses
import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu.audio.features import (
    log_mel_spectrogram as jax_log_mel_spectrogram,
)
from whisper_trtllm_tpu.benchmarks import roofline as jax_roofline
from whisper_trtllm_tpu.models.whisper import init_params as jax_init_params
from whisper_trtllm_tpu.quantization import (
    weight_only_quantize as jax_weight_only_quantize,
)
from whisper_trtllm_tpu.runtime.generation import (
    transcribe_tokens as jax_transcribe_tokens,
)
from whisper_trtllm_tpu_torch import config as torch_config
from whisper_trtllm_tpu_torch.benchmarks import benchmark, mem_monitor
from whisper_trtllm_tpu_torch.benchmarks import roofline
from whisper_trtllm_tpu_torch.cli import bench, gpu_check

PRESETS = ["tiny.en", "base.en", "small.en", "medium.en", "large-v3"]


def _configs(preset):
    return (jax_config.WhisperConfig.preset(preset),
            torch_config.WhisperConfig.preset(preset))


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_roofline_counts_equal_the_jax_modules(preset):
    jcfg, cfg = _configs(preset)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    for name in ("encoder_flops", "cross_kv_flops", "decoder_weight_bytes"):
        assert getattr(roofline, name)(cfg) == getattr(jax_roofline, name)(jcfg)
    for step in (0, 1, 23, 47, 447):
        assert (roofline.decode_step_flops(cfg, step)
                == jax_roofline.decode_step_flops(jcfg, step))
    for gen in (1, 48, 96):
        assert roofline.decode_flops(cfg, gen) == jax_roofline.decode_flops(
            jcfg, gen)
        assert (roofline.pipeline_flops_per_utt(cfg, gen)
                == jax_roofline.pipeline_flops_per_utt(jcfg, gen))
    for wb, vb in ((1.0, 1.0), (1.0, 2.0), (4.0, 4.0)):
        assert (roofline.decoder_weight_bytes(cfg, wb, vb)
                == jax_roofline.decoder_weight_bytes(jcfg, wb, vb))
    assert (roofline.decode_bytes_per_step(cfg, 16, 24)
            == jax_roofline.decode_bytes_per_step(jcfg, 16, 24))


# (weight_bytes, kv_bytes, vocab_bytes, kv_scale_bytes): bf16 weights and
# KV; the headline's bf16 weights with int8 KV and fp32 scales; the
# sections' int8 weights and KV with a bf16 vocab table; fp32 throughout
WIDTHS = [(2.0, 2.0, 2.0, 0.0), (2.0, 1.0, 2.0, 4.0), (1.0, 1.0, 2.0, 4.0),
          (4.0, 4.0, 4.0, 0.0)]


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("batch", [1, 16, 32])
def test_decode_bytes_per_step_equals_the_jax_modules(batch, widths):
    wb, kb, vb, sb = widths
    for preset in PRESETS:
        jcfg, cfg = _configs(preset)
        for cache_len in (0, 1, 24, 447):
            assert roofline.decode_bytes_per_step(
                cfg, batch, cache_len, weight_bytes=wb, kv_bytes=kb,
                vocab_bytes=vb, kv_scale_bytes=sb
            ) == jax_roofline.decode_bytes_per_step(
                jcfg, batch, cache_len, weight_bytes=wb, kv_bytes=kb,
                vocab_bytes=vb, kv_scale_bytes=sb)


def test_chip_peaks_are_the_h100_data_sheets_and_nothing_else():
    assert roofline.chip_peaks("NVIDIA H100 80GB HBM3") == (989.0, 3350.0)
    for unknown in ("Mystery Card", "NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                    "TPU v5e", ""):
        assert roofline.chip_peaks(unknown) == (None, None)
    assert list(roofline.CHIP_PEAKS) == ["NVIDIA H100 80GB HBM3"]


# --------------------------------------------------------------------------
# mem_monitor
# --------------------------------------------------------------------------

def test_memory_monitor_reads_minus_one_on_the_cpu(monkeypatch):
    assert mem_monitor.get_memory_info("cpu") == (-1.0, -1.0, -1.0)
    mon = mem_monitor.MemoryMonitor("cpu").start()
    x = torch.ones(1 << 16)
    assert mon.stop() == -1.0
    assert mon.stop() == -1.0  # stopping twice is safe
    del x
    # no card: the default device (the card) has no statistics either
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mem_monitor.get_memory_info() == (-1.0, -1.0, -1.0)
    assert mem_monitor.MemoryMonitor().start().stop() == -1.0


# --------------------------------------------------------------------------
# the timed pipeline against the JAX package
# --------------------------------------------------------------------------

def _jax_tokens(jcfg, mel, kv, weights, gen_tokens, seed):
    jcfg = dataclasses.replace(jcfg, eos_token_id=-1)
    params = jax_init_params(jcfg, seed=seed)
    if weights == "int8":
        params = jax_weight_only_quantize(params)
    gen = jax_config.GenerationConfig(max_new_tokens=gen_tokens,
                                      kv_cache_dtype=kv)
    toks, lens = jax_transcribe_tokens(params, jcfg, jnp.asarray(mel), gen)
    return np.asarray(toks), np.asarray(lens)


@pytest.mark.parametrize("kv,weights", [("auto", "native"), ("int8", "native"),
                                        ("int8", "int8")])
def test_bench_pipeline_tokens_equal_jax_on_mels(kv, weights):
    """The sections' path (mels in) at a testing config, fp32: float KV,
    int8 KV (cross cache T-minor through "auto"), and int8 weight-only
    weights through the session's load-time chain with int8 KV."""
    jcfg = jax_config.WhisperConfig.testing()
    cfg = torch_config.WhisperConfig.testing()
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal(
        (3, 2 * cfg.max_source_positions, cfg.num_mel_bins)) * 0.5
    ).astype(np.float32) for _ in range(2)]
    session = bench.bench_session(cfg, kv, "float32", weight_dtype=weights,
                                  gen_tokens=12, seed=4, device="cpu")
    assert session.cfg.eos_token_id == -1
    tokens = bench.run_pass(
        session, [torch.from_numpy(b) for b in batches], frontend=False)
    ref_toks, ref_lens = _jax_tokens(jcfg, batches[-1], kv, weights, 12, 4)
    np.testing.assert_array_equal(tokens, ref_toks)
    # EOS disabled: every utterance decodes the whole buffer
    assert tokens.shape == (3, 13) and (ref_lens == 13).all()


def test_bench_pipeline_tokens_equal_jax_on_audio():
    """The headline's path (audio in, the frontend inside the pass) with
    int8 KV, at narrow widths but the real 30 s window (1500 encoder
    positions, 80 mels), fp32."""
    over = dict(max_source_positions=1500, num_mel_bins=80)
    jcfg = jax_config.WhisperConfig.testing(**over)
    cfg = torch_config.WhisperConfig.testing(**over)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 480000)).astype(np.float32)
             * np.float32(0.1))
    session = bench.bench_session(cfg, "int8", "float32", gen_tokens=6,
                                  seed=2, device="cpu")
    tokens = bench.run_pass(session, [torch.from_numpy(audio)],
                            frontend=True)
    mel = np.asarray(jax_log_mel_spectrogram(audio))
    ref_toks, _ = _jax_tokens(jcfg, mel, "int8", "native", 6, 2)
    np.testing.assert_array_equal(tokens, ref_toks)


def test_series_reports_the_median_rate_and_its_spread(monkeypatch):
    passes = []
    monkeypatch.setattr(bench, "run_pass",
                        lambda *a, **k: passes.append("warm-up"))

    def timed(fn, device, iters, warmup):
        assert passes == ["warm-up"] and (iters, warmup) == (3, 0)
        return None, [2000.0, 4000.0, 1000.0]  # three timed passes, ms

    monkeypatch.setattr(bench, "timed_calls", timed)
    batches = [np.zeros((4, 1))] * 3
    s = bench.series(type("S", (), {"device": torch.device("cpu")})(),
                     batches, frontend=False)
    audio_s = 12 * bench.AUDIO_SECONDS_PER_UTT
    assert s["audio_s_per_s"] == audio_s / 2.0
    assert (s["min"], s["max"], s["n"]) == (audio_s / 4.0, audio_s / 1.0, 3)
    assert s["seconds"] == 2.0 and s["peak_mem_gib"] == -1.0


def test_timed_calls_times_each_call_after_the_warm_up():
    calls = []

    def fn():
        calls.append(len(calls))
        return len(calls)

    out, ms = benchmark.timed_calls(fn, torch.device("cpu"), 3, warmup=2)
    assert calls == [0, 1, 2, 3, 4] and out == 5
    assert len(ms) == 3 and all(t >= 0 for t in ms)
    assert benchmark.timed_calls(fn, torch.device("cpu"), 0, warmup=0) == (
        None, [])


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------

@pytest.fixture()
def state_path(tmp_path, monkeypatch):
    p = tmp_path / "gpu_check_state.json"
    monkeypatch.setenv(gpu_check.STATE_PATH_ENV, str(p))
    return p


class FakeRun:
    """Stands in for the ``cli.gpu_check`` subprocess; writes the record a
    full run would, if given one."""

    def __init__(self, path, writes=None, returncode=0):
        self.calls, self.path = [], path
        self.writes, self.returncode = writes, returncode

    def __call__(self, cmd, **kw):
        self.calls.append(cmd)
        if self.writes is not None:
            self.path.write_text(json.dumps(self.writes))
        return subprocess.CompletedProcess(cmd, self.returncode, "", "boom")


def _record(passing=True, digest=None):
    return {"ts": 1.0, "git_head": "abc1234", "pass": passing,
            "kernel_tree_digest": (gpu_check.kernel_tree_digest()
                                   if digest is None else digest)}


def test_gate_passes_a_fresh_record_without_a_rerun(state_path, monkeypatch):
    state_path.write_text(json.dumps(_record()))
    fake = FakeRun(state_path)
    monkeypatch.setattr(subprocess, "run", fake)
    gate = bench.gpu_check_gate()
    assert gate["status"] == "pass" and not gate["rerun"]
    assert fake.calls == [] and "stale_digest" not in gate


def test_gate_reruns_a_stale_record_and_fails_if_still_stale(state_path,
                                                             monkeypatch):
    state_path.write_text(json.dumps(_record(digest="0" * 16)))
    fake = FakeRun(state_path, returncode=1)  # the rerun writes nothing
    monkeypatch.setattr(subprocess, "run", fake)
    gate = bench.gpu_check_gate()
    assert len(fake.calls) == 1
    assert fake.calls[0][1:] == ["-m", "whisper_trtllm_tpu_torch.cli.gpu_check"]
    assert gate["status"] == "fail"
    assert gate["stale_digest"] == {"record": "0" * 16,
                                    "tree": gpu_check.kernel_tree_digest()}
    assert "exit 1" in gate["rerun_error"]


@pytest.mark.parametrize("record", [_record(passing=False),
                                    _record(digest="f" * 16)])
def test_gate_passes_once_the_rerun_writes_a_passing_record(state_path,
                                                           monkeypatch,
                                                           record):
    state_path.write_text(json.dumps(record))
    fake = FakeRun(state_path, writes=_record())
    monkeypatch.setattr(subprocess, "run", fake)
    gate = bench.gpu_check_gate()
    assert len(fake.calls) == 1 and gate["status"] == "pass" and gate["rerun"]


def test_gate_missing_record_fails_main_before_measuring(state_path,
                                                         monkeypatch, capsys):
    fake = FakeRun(state_path)  # the rerun writes no record
    monkeypatch.setattr(subprocess, "run", fake)
    gate = bench.gpu_check_gate()
    assert gate["status"] == "missing" and len(fake.calls) == 1
    # main with a card: the gate refuses before any measurement
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "bench_session", pytest.fail)
    assert bench.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"gpu_check": line["gpu_check"]}
    assert line["gpu_check"]["status"] == "missing"


# --------------------------------------------------------------------------
# without a card, and what is not ported
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,family,width", [
    ("gptj_6b", "gptj", 4096), ("gptneox_20b", "gptneox", 6144),
    ("gpt_175b", "gpt", 12288), ("opt_66b", "opt", 9216),
    ("chatglm_6b", "chatglm6b", 4096)])
def test_the_wide_zoo_configs_build(name, family, width):
    """The names whose widths reach K5 past 2048 (and GPT-J's head dim of
    256, K1 and K2 past 128) build: family, config class and widths."""
    from whisper_trtllm_tpu_torch.benchmarks.allowed_configs import (
        ALLOWED_CONFIGS,
        build_model,
    )

    fam, cfg, init_params, generate, forward = build_model(name)
    assert fam == family == ALLOWED_CONFIGS[name].family
    assert cfg.d_model == width and width <= 16384
    assert cfg.head_dim <= 256
    assert callable(init_params) and callable(generate) and callable(forward)
    if name == "gptj_6b":
        assert cfg.head_dim == 256 and cfg.rotary_dim == 64


@pytest.mark.parametrize("main", [bench.main, benchmark.main])
def test_entry_points_exit_nonzero_without_a_card(main, monkeypatch, capsys,
                                                  state_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "run", pytest.fail)
    assert main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA card" in out.err


@pytest.mark.parametrize("kwargs,item", [
    (dict(name="bert_base", quant="sq"), "item 11"),
    (dict(name="bert_large", quant="sq"), "item 11"),
    (dict(name="gpt_350m", quant="sq"), "item 11"),
])
def test_unported_inputs_raise_naming_their_roadmap_item(kwargs, item):
    args = dict(batch=1, in_len=4, out_len=2, dtype="float32", iters=1,
                device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        benchmark.bench_zoo(**{**args, **kwargs})
    # a zoo name or --quant is not a Whisper row's
    with pytest.raises(ValueError):
        benchmark.bench_config("gpt_350m", 1, "float32", gen_tokens=2,
                               iters=1, device="cpu")
    with pytest.raises(ValueError, match="quant"):
        benchmark.bench_config("tiny.en", 1, "float32", gen_tokens=2,
                               iters=1, quant="int8", device="cpu")


def test_bench_config_row_has_the_jax_rows_keys_on_the_cpu():
    row = benchmark.bench_config("tiny.en", 1, "float32", gen_tokens=2,
                                 iters=2, device="cpu")
    jax_keys = {"peak_mem_gib", "model", "batch", "dtype", "num_beams",
                "gen_tokens", "latency_ms_p50", "latency_ms_p95",
                "latency_ms_p99", "tokens_per_s", "audio_s_per_s", "backend"}
    assert jax_keys <= set(row)
    assert row["backend"] == "cpu" and row["device"] is None
    assert row["peak_mem_gib"] == -1.0 and row["launches"] == {}
    assert row["audio_s_per_s"] > 0 and row["iters"] == 2


def test_bench_config_runs_beams_on_the_cpu():
    """``--num-beams`` K > 1: the session's beam branch, the JAX row's keys
    and formulas (tokens counted for the best hypothesis)."""
    row = benchmark.bench_config("tiny.en", 1, "float32", gen_tokens=2,
                                 iters=1, num_beams=2, device="cpu")
    assert row["num_beams"] == 2 and row["backend"] == "cpu"
    batch_s = row["latency_ms_p50"] / 1e3
    assert row["tokens_per_s"] == pytest.approx(1 * 2 / batch_s)
    assert row["audio_s_per_s"] == pytest.approx(30.0 / batch_s)
