"""PyTorch port: it stands alone and never falls back to the CPU.

- The package and ``chip_smoke.py`` import without JAX, flax,
  ``ml_dtypes``, the JAX package or ``cli`` (checked in a fresh
  interpreter where importing JAX, flax or ``ml_dtypes`` fails).
- No port module calls a fused attention operator, ``torch.compile`` or a
  package of finished kernels.
- Entry points called without ``device=`` raise when there is no CUDA;
  the fine-tuning, serving and dataset CLIs (transcribe, cal_wer, accept,
  synthetic_asr, warm_cache, build, visualize) without ``--cpu`` too, the
  speculative scripts without ``--device cpu``; the zoo's models,
  ``cli/run_zoo.py`` and ``bench_zoo`` too, and the parallel dry run's
  ranks run on the cards unless told ``cpu=True``.
- ``chip_smoke.py`` exits non-zero and prints no result without a card.
"""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
import whisper_trtllm_tpu_torch
from whisper_trtllm_tpu_torch.audio import LogMelSpectrogram, log_mel_spectrogram
from whisper_trtllm_tpu_torch.config import WhisperConfig
from whisper_trtllm_tpu_torch.models.whisper.model import (
    init_self_kv,
    init_self_kv_quant,
)
from whisper_trtllm_tpu_torch.ops.attention import init_kv_cache
from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "whisper_trtllm_tpu_torch")
ART = os.path.join(ROOT, "artifacts", "tiny_en_synth_int8")

_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["ml_dtypes"] = None
sys.path.insert(0, {root!r})
import whisper_trtllm_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "whisper_trtllm_tpu" or n.startswith("whisper_trtllm_tpu.")
             or n == "cli" or n.startswith("cli.")
             or (n.split(".")[0] in ("jax", "flax", "ml_dtypes")
                 and sys.modules[n] is not None))
print("IMPORTED", bad)
"""


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(
        whisper_trtllm_tpu_torch.__path__, "whisper_trtllm_tpu_torch.")]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_JAX.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120, env=env,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout, out.stdout
    assert len(_port_modules()) >= 15
    for name in ("training", "training.train", "cli", "cli.finetune",
                 "cli.gpu_check", "layers.init", "models.whisper.convert",
                 "ops.kernels.cross_attention",
                 "examples.custom_kernel.custom_gelu_kernel",
                 "benchmarks.roofline", "benchmarks.mem_monitor",
                 "benchmarks.benchmark", "cli.bench", "native",
                 "native.lib", "runtime.ifb", "runtime.server",
                 "runtime.kv_cache_manager", "cli.serve",
                 "benchmarks.serve_loadtest", "quantization.mode",
                 "quantization.quantize", "quantization.smooth",
                 "runtime.speculative", "benchmarks.spec_bench",
                 "benchmarks.spec_loop_cost", "cli.transcribe",
                 "cli.cal_wer", "cli.accept", "cli.synthetic_asr",
                 "cli.warm_cache", "cli.build", "cli.visualize",
                 "utils.logger", "utils.normalizer", "utils.metrics",
                 "utils.profiler", "utils.debugging", "utils.engine",
                 "runtime.export", "parallel", "parallel.mesh",
                 "parallel.partition", "parallel.collectives",
                 "parallel.dryrun", "benchmarks.scaling", "models.zoo",
                 "models.gpt", "models.gpt.model", "models.opt",
                 "models.opt.model", "models.llama", "models.llama.model",
                 "models.gptj", "models.gptj.model", "models.gptneox",
                 "models.gptneox.model", "runtime.causal_lm", "runtime.beam_lm",
                 "benchmarks.allowed_configs", "benchmarks.stft_witness",
                 "cli.run_zoo", "runtime.ifb_lm", "runtime.ifb_paged",
                 "runtime.beam_paged", "models.bert", "models.bert.model",
                 "models.unet", "models.unet.model"):
        assert f"whisper_trtllm_tpu_torch.{name}" in _port_modules()


def test_port_sources_call_no_fused_attention_or_compiler():
    banned = ("scaled_dot_product_attention", "torch.compile", "import jax",
              "from jax", "flash_attn", "xformers", "cudnn_attention",
              "whisper_trtllm_tpu.", "from cli", "import cli")
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith((".py", ".cu")):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                text = f.read()
            for word in banned:
                assert word not in text, f"{path} mentions {word!r}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(ART)
    params, cfg = load_checkpoint(ART, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperSession(params, cfg)
    mel = np.zeros((1, 3000, 80), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe_tokens(params, cfg, mel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        log_mel_spectrogram(np.zeros(16000, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogMelSpectrogram()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_self_kv(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_self_kv_quant(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_cache(1, 2, 4, 8)


def test_serving_entry_points_default_to_the_card_and_raise_without_one(
        no_cuda):
    from whisper_trtllm_tpu_torch.cli import serve
    from whisper_trtllm_tpu_torch.ops.attention import init_paged_kv_cache
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher
    from whisper_trtllm_tpu_torch.runtime.server import IfbTranscriptionServer

    params, cfg = load_checkpoint(ART, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InflightBatcher(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IfbTranscriptionServer(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_kv_cache(4, 2, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_server(serve.parse_args(["--checkpoint", ART]))


def test_speculative_entry_points_default_to_the_card_and_raise_without_one(
        no_cuda):
    from whisper_trtllm_tpu_torch.benchmarks import spec_bench, spec_loop_cost
    from whisper_trtllm_tpu_torch.runtime.speculative import (
        speculative_transcribe_tokens,
    )

    params, cfg = load_checkpoint(ART, device="cpu")
    mel = np.zeros((1, 3000, 80), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speculative_transcribe_tokens(params, cfg, params, cfg, mel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec_bench.main(["--target", ART, "--draft", ART, "--wav-dir",
                         os.path.join(ROOT, "artifacts", "eval")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec_loop_cost.main([])


def test_finetune_defaults_to_the_card_and_raises_without_one(no_cuda,
                                                            tmp_path):
    from whisper_trtllm_tpu_torch.cli import finetune

    args = ["--checkpoint", ART, "--dataset", str(tmp_path / "none.pkl"),
            "--output", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(args)
    # with --cpu it gets past the device and reads the dataset
    with pytest.raises(FileNotFoundError):
        finetune.main(args + ["--cpu"])


def test_dataset_clis_default_to_the_card_and_raise_without_one(no_cuda,
                                                               tmp_path):
    from whisper_trtllm_tpu_torch.cli import (
        accept,
        build,
        cal_wer,
        synthetic_asr,
        transcribe,
        visualize,
        warm_cache,
    )

    pkl = str(tmp_path / "none.pkl")
    calls = [
        (transcribe.main, ["--checkpoint", ART]),
        (cal_wer.main, ["--checkpoint", ART, "--dataset", pkl,
                        "--hf-model", "none"]),
        (accept.main, ["--checkpoint", ART, "--dataset", pkl]),
        (synthetic_asr.main, ["make", "--out", str(tmp_path / "s")]),
        (synthetic_asr.main, ["export-hf", "--checkpoint", ART, "--hf-dir",
                              str(tmp_path / "hf")]),
        (warm_cache.main, ["--checkpoint", ART, "--batch", "1"]),
        (build.main, ["--model", str(tmp_path), "--output",
                      str(tmp_path / "o")]),
        (visualize.main, ["--checkpoint", ART, "--out", str(tmp_path / "g")]),
    ]
    for main, args in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
    # with --cpu it gets past the device and reads its input
    with pytest.raises(FileNotFoundError):
        transcribe.main(["--checkpoint", ART, "--dataset", pkl, "--cpu"])


def test_zoo_entry_points_default_to_the_card_and_raise_without_one(no_cuda):
    import inspect

    from whisper_trtllm_tpu_torch.benchmarks import benchmark
    from whisper_trtllm_tpu_torch.cli import run_zoo
    from whisper_trtllm_tpu_torch.models import gpt, gptj, gptneox, llama, opt
    from whisper_trtllm_tpu_torch.parallel import dryrun

    prompt = np.asarray([[3, 4, 5]], np.int32)
    for mod, cfg in ((gpt, gpt.GPTConfig.testing()),
                     (opt, opt.OPTConfig.testing()),
                     (llama, llama.LlamaConfig.testing()),
                     (gptj, gptj.GPTJConfig.testing()),
                     (gptneox, gptneox.GPTNeoXConfig.testing())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.init_params(cfg)
        params = mod.init_params(cfg, device="cpu")
        for call in (lambda: mod.generate(params, cfg, prompt, 2),
                     lambda: mod.generate_ragged(params, cfg, prompt, [3], 2),
                     lambda: mod.generate_beam(params, cfg, prompt, 2, 2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_zoo.main(["--family", "gpt", "--prompt-ids", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.bench_zoo("gpt_tiny", 1, 4, 2, "float32", 1)
    # the parallel dry run spawns NCCL ranks on the cards unless told
    assert inspect.signature(dryrun.spawn).parameters["cpu"].default is False
    for fn in (dryrun.serve_checks, dryrun.train_checks,
               dryrun.dryrun_checks):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_zoo_runtimes_and_encoders_default_to_the_card(no_cuda):
    """The batchers, the paged beam search, BERT's and the UNet's
    ``init_params`` and converters raise without ``device=`` when there is
    no card; with ``device="cpu"`` they run."""
    from whisper_trtllm_tpu_torch.models import bert, gpt, unet
    from whisper_trtllm_tpu_torch.models.gpt import model as gm
    from whisper_trtllm_tpu_torch.runtime.beam_paged import paged_beam_search
    from whisper_trtllm_tpu_torch.runtime.ifb_lm import (
        CausalLMInflightBatcher,
    )
    from whisper_trtllm_tpu_torch.runtime.ifb_paged import (
        PagedCausalLMInflightBatcher,
    )

    cfg = gpt.GPTConfig.testing()
    params = gpt.init_params(cfg, device="cpu")
    common = dict(cache_heads=cfg.n_head, head_dim=cfg.head_dim,
                  n_layer=cfg.n_layer, eos_token_id=cfg.eos_token_id)
    paged = dict(prefill=lambda *a: gm._prefill_paged(a[0], cfg, *a[1:]),
                 step=lambda *a: gm._step_paged(a[0], cfg, *a[1:]))
    for call in (
            lambda: CausalLMInflightBatcher(
                params, cfg, prefill=None, step=None, **common),
            lambda: PagedCausalLMInflightBatcher(
                params, cfg, num_blocks=4, **paged, **common),
            lambda: paged_beam_search(
                paged["prefill"], paged["step"], params, [3, 4, 5, 6],
                pool_shape=(2, 8, 4, 4, 8), tokens_per_block=4,
                max_blocks_per_seq=4, max_new_tokens=2, eos_token_id=2,
                num_beams=2),
            lambda: bert.init_params(bert.BertConfig.testing()),
            lambda: unet.init_params(unet.UNetConfig.testing()),
            lambda: unet.convert_diffusers_unet({}, unet.UNetConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    b = PagedCausalLMInflightBatcher(params, cfg, num_blocks=8, **paged,
                                     **common, max_prompt_len=4,
                                     max_new_tokens=4, device="cpu")
    rid = b.submit([3, 4])
    b.run()
    assert b.fetch(rid) is not None and b.free_blocks() == 8


def test_transcribe_tokens_refuses_params_on_another_device():
    params = {"encoder": {"conv1": {"kernel": torch.zeros(3, 80, 8,
                                                          device="meta")}}}
    with pytest.raises(ValueError, match="params lie on"):
        transcribe_tokens(params, WhisperConfig.testing(),
                          np.zeros((1, 48, 16), np.float32), device="cpu")


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_alone_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
