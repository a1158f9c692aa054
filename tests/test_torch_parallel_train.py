"""PyTorch port: the sharded train step, the sharded checkpoint, the
fine-tuning CLI over a mesh and the scaling ladder, against the JAX package
on the CPU.

One world of 4 gloo ranks (``parallel/dryrun.py::spawn`` of
``train_checks``, on a ``file://`` store under the test's temporary
directory) runs the train steps, the DCP round trip, ``check_devices`` and
``benchmarks/scaling.py``; ``cli.finetune`` runs under ``torchrun
--standalone`` (a free port) at dp 2 × mp 2 with ``--cpu``.

Tolerances: one AdamW step (lr 1e-4) against JAX's unsharded step: the
loss 1e-5 relative, every leaf's gradient 1e-5 of that leaf's largest |g|
(fp32 sums in another order), and the parameters after the step 1e-6
absolute wherever JAX's gradient is at least ``ADAM_FLOOR`` in size, 1e-5
(a tenth of lr) below it. Adam divides a gradient by its own size plus
eps 1e-8: a component whose gradient is within a few hundred eps of zero
turns the fp32 reordering noise of its gradient into a step difference of
several 1e-6 (the port's one-device step differs from JAX's by up to
6.8e-6 on this batch, at a gradient of 3e-8). Against JAX's sharded step
on the same mesh the loss 1e-5 relative; checkpoints exact.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_threads
from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu import config as jax_config
from whisper_trtllm_tpu import training as jax_training
from whisper_trtllm_tpu.models.whisper import model as jax_model
from whisper_trtllm_tpu.parallel import make_mesh as jax_make_mesh
from whisper_trtllm_tpu.parallel import partition as jax_partition
from whisper_trtllm_tpu.utils.checkpoint import load_checkpoint as jax_load
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel import dryrun
from whisper_trtllm_tpu_torch.training import guided_attn_weights
from whisper_trtllm_tpu_torch.utils.checkpoint import (
    load_sharded,
    save_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
WORLD_TIMEOUT_S = 300
# |g| below which Adam's step is dominated by the gradient's rounding
ADAM_FLOOR = 1e-6
STEPS = {"step (2, 2)": (4, 64, (2, 2), False),
         "guided step (2, 2)": (4, 64, (2, 2), True),
         "six heads step (1, 4)": (6, 96, (1, 4), False)}


class World:
    """The world, started when the module's first test starts, while the
    tests compute the JAX package's results: ``ranks()`` waits for it."""

    def __init__(self, workdir):
        self.workdir = str(workdir)
        self._pool = ThreadPoolExecutor(1)
        self._run = self._pool.submit(dryrun.spawn, WORLD, "train",
                                      workdir=self.workdir,
                                      cpu=True, timeout=WORLD_TIMEOUT_S,
                                      env=torch_threads.rank_env())

    def ranks(self):
        return self._run.result()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("train_world"))
    yield w
    w._pool.shutdown(wait=True)


def _jcfg(cfg):
    return jax_config.WhisperConfig(**dataclasses.asdict(cfg))


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_step(name, mesh_shape=None):
    heads, d, _, guided = STEPS[name]
    cfg = dryrun.testing_config(heads, d, 2 * d)
    jcfg = _jcfg(cfg)
    mel, tokens, mask = dryrun.train_batch(cfg, 4, 1)
    ga = ((guided_attn_weights(7, cfg.max_source_positions), 0.5)
          if guided else (None, None))
    params = jax_model.init_params(jcfg, seed=0)
    mesh = None
    if mesh_shape is not None:
        mesh = jax_make_mesh(jax_config.MeshConfig(*mesh_shape),
                             devices=jax.devices()[:WORLD])
        params = jax_partition.shard_params(params, mesh)
        ds = NamedSharding(mesh, P("data"))
        mel, tokens, mask = (jax.device_put(x, ds)
                             for x in (mel, tokens, mask))
    if mesh is not None:
        init, step = jax_training.make_train_step(jcfg, optax.adamw(1e-4),
                                                  mesh=mesh)
        with mesh:
            params, _, loss = step(params, init(params), mel, tokens, mask,
                                   *ga)
        return float(loss), None, _flat(params)
    # the JAX step's arithmetic: value_and_grad, then optax.adamw(1e-4)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_training.cross_entropy_loss(p, jcfg, mel, tokens, mask,
                                                  *ga)))(params)
    opt = optax.adamw(1e-4)
    updates, _ = opt.update(grads, opt.init(params), params)
    return (float(loss), _flat(grads),
            _flat(optax.apply_updates(params, updates)))


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_equal_jax(world, name):
    """Masks differ between the data ranks: the loss is normalised by the
    whole batch's count, the data ranks' gradients summed."""
    loss, grads, params = _jax_step(name)
    ranks = world.ranks()
    for r in range(WORLD):
        got_loss, got_grads, got = ranks[r][name]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        assert set(got) == set(params) == set(got_grads)
        for k, want in grads.items():
            np.testing.assert_allclose(
                got_grads[k], want, rtol=0,
                atol=1e-5 * max(np.abs(want).max(), 1e-30),
                err_msg=f"rank {r}: gradient of {k}")
        for k, want in params.items():
            tol = np.where(np.abs(grads[k]) >= ADAM_FLOOR, 1e-6, 1e-5)
            np.testing.assert_array_less(np.abs(got[k] - want), tol + 1e-12,
                                         err_msg=f"rank {r}: {k}")


def test_train_step_loss_equal_jax_sharded(world):
    loss, _, _ = _jax_step("step (2, 2)", mesh_shape=(2, 2))
    ranks = world.ranks()
    assert abs(ranks[0]["step (2, 2)"][0] - loss) <= 1e-5 * abs(loss)


def test_dcp_checkpoint_reshards_exactly(world):
    """Written by the (1, 4) mesh (6 heads: 2, 2, 2, 0), read straight into
    the (2, 2) mesh's shards."""
    ranks = world.ranks()
    for r in range(WORLD):
        got, want = ranks[r]["dcp resharded"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dcp_checkpoint_holds_the_jax_tree(world):
    cfg = dryrun.testing_config(6, 96, 192)
    want = _flat(jax_model.init_params(_jcfg(cfg), seed=3))
    ranks, workdir = world.ranks(), world.workdir
    # read whole on every rank of the world, and here, with no world
    here = dryrun.numpy_tree(load_sharded(os.path.join(workdir, "ckpt"),
                                          device="cpu"))
    for got in [ranks[r]["dcp whole"] for r in range(WORLD)] + [here]:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_check_devices(world):
    ranks = world.ranks()
    for r in range(WORLD):
        assert ranks[r]["check_devices (2, 2)"] == {"devices": WORLD,
                                                    "ok": True}


def test_scaling_rows(world):
    """The JAX script's rows: 1, 2 and 4 devices measured, efficiency 1.0
    at the first, 8 skipped."""
    ranks = world.ranks()
    import json

    rows = [json.loads(line) for line in ranks[0]["scaling"].splitlines()]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["scaling_efficiency"] == 1.0
    for row, data in zip(rows[:3], (1, 2, 4)):
        assert row["mesh"] == f"data={data} model=1"
        assert row["batch"] == data and row["audio_s_per_s"] > 0
        assert row["latency_ms"] > 0 and row["scaling_efficiency"] > 0
    assert rows[3] == {"devices": 8, "skipped": "only 4 available"}
    assert all(not ranks[r]["scaling"] for r in range(1, WORLD))


def _finetune_inputs(tmp_path):
    cfg = dryrun.testing_config(4, 64, 128)
    ckpt = str(tmp_path / "base")
    save_checkpoint(ckpt, wmodel.init_params(cfg, seed=0, device="cpu"), cfg)
    rng = np.random.default_rng(5)
    data = [(rng.standard_normal((48, 16)).astype(np.float32),
             [1] + rng.integers(3, 128, 3 + i).tolist() + [2])
            for i in range(4)]
    dataset = str(tmp_path / "train.pkl")
    with open(dataset, "wb") as f:
        pickle.dump(data, f)
    return ["--checkpoint", ckpt, "--dataset", dataset, "--epochs", "1",
            "--batch", "4", "--max-target-len", "8", "--cpu"]


def test_finetune_under_torchrun_equal_to_one_device(tmp_path):
    from whisper_trtllm_tpu_torch.cli import finetune

    args = _finetune_inputs(tmp_path)
    finetune.main(args + ["--output", str(tmp_path / "one")])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "whisper_trtllm_tpu_torch.cli.finetune",
         "--data-parallel", "2", "--model-parallel", "2",
         "--output", str(tmp_path / "mesh")] + args,
        capture_output=True, text=True, timeout=WORLD_TIMEOUT_S, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("epoch 0: loss") == 1, out.stdout
    one, _ = jax_load(str(tmp_path / "one"))
    mesh, _ = jax_load(str(tmp_path / "mesh"))
    one, mesh = _flat(one), _flat(mesh)
    assert set(one) == set(mesh)
    for k in one:
        np.testing.assert_allclose(mesh[k], one[k], rtol=0, atol=1e-6,
                                   err_msg=k)
