"""Dry run of the port's on-card regression check
(``whisper_trtllm_tpu_torch/cli/gpu_check.py``), after
``tests/test_tpu_check_harness.py``: without a card it refuses unless
given ``--cpu``; with ``--cpu`` the checks of paths run through the plain
versions and the kernel checks report ``"pass": null``; no CPU or subset
run writes the state record. The run on the card is
``tests/test_torch_gpu.py::test_gpu_check_passes_on_the_card``."""

import json
import shutil

import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu_torch.cli import gpu_check

KERNEL_CHECKS = {"flash_fwd", "flash_bwd", "flash_causal", "decode_kernel",
                 "fused_layer", "cross_attn_kernel", "stft_kernel"}


@pytest.fixture
def state(tmp_path, monkeypatch):
    path = tmp_path / "state.json"
    monkeypatch.setenv(gpu_check.STATE_PATH_ENV, str(path))
    return path


def test_check_refuses_without_a_card_or_cpu(monkeypatch, capsys, state):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = gpu_check.main([])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and out["pass"] is False and "--cpu" in out["error"]
    assert not state.exists()


def test_cpu_dry_run_of_a_subset_passes(capsys, state):
    rc = gpu_check.main(["--cpu", "--only", "int8_kv_fold",
                         "step_equals_full", "int8_kv_greedy",
                         "cross_attn_kernel"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0, out
    assert out["pass"] is True and out["device"] == "cpu"
    for name in ("int8_kv_fold", "step_equals_full", "int8_kv_greedy"):
        assert out[name]["pass"] is True
        assert out[name]["launches"] == {}  # the plain versions launch none
    assert out["int8_kv_fold"]["max_err"] < 2e-4
    assert out["step_equals_full"]["max_err"] < 2e-4
    assert out["int8_kv_greedy"]["token_agreement"] >= 0.8
    assert out["cross_attn_kernel"] == {"pass": None,
                                        "skipped": "needs the card"}
    assert not state.exists()


def test_full_cpu_dry_run_skips_every_kernel_check_and_writes_no_state(
        capsys, state):
    rc = gpu_check.main(["--cpu"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and out["pass"] is True
    checks = {k for k, v in out.items() if isinstance(v, dict)}
    assert checks == set(gpu_check.CHECKS) and len(checks) == 13
    assert {k for k in checks if out[k]["pass"] is None} == KERNEL_CHECKS
    assert out["ifb_quantized_lanes"]["exact"] == 3
    assert out["ifb_quantized_lanes"]["quantized_lanes"] is True
    assert out["paged_vs_contiguous"]["max_err"] < 1e-6
    beam = out["beam_path"]
    assert beam["pass"] is True and beam["beam1_eq_greedy"]
    assert beam["k2_sorted"] and beam["k2_finite"] and beam["prefix_len"] > 2
    assert not state.exists()


def test_unknown_check_names_are_refused():
    with pytest.raises(SystemExit):
        gpu_check.main(["--cpu", "--only", "no_such_check"])


def test_kernel_tree_digest_covers_the_cuda_sources(tmp_path):
    pkg = tmp_path / "whisper_trtllm_tpu_torch"
    shutil.copytree(gpu_check.ROOT + "/whisper_trtllm_tpu_torch/csrc",
                    pkg / "csrc")
    (pkg / "ops").mkdir()
    (pkg / "ops" / "a.py").write_text("x = 1\n")
    before = gpu_check.kernel_tree_digest(str(tmp_path))
    assert before == gpu_check.kernel_tree_digest(str(tmp_path))
    src = pkg / "csrc" / "cross_attention.cu"
    src.write_text(src.read_text() + "// edited\n")
    edited = gpu_check.kernel_tree_digest(str(tmp_path))
    assert edited != before
    (pkg / "ops" / "notes.txt").write_text("not a source\n")
    assert gpu_check.kernel_tree_digest(str(tmp_path)) == edited
