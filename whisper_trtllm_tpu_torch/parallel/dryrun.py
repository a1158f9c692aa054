"""Multi-rank dry run of data and tensor parallelism (counterpart of
``__graft_entry__.py::dryrun_multichip``), and the rank side of the port's
multi-process tests.

    python -m whisper_trtllm_tpu_torch.parallel.dryrun N [--cpu]

spawns a world of N ranks, one process each (gloo on the CPU with
``--cpu``, else NCCL over N cards), on a ``file://`` store in a new
temporary directory, and runs ``dryrun`` on every rank: at d 64 and 8
heads, one train step over a (data, model) mesh with both axes above 1
where N allows, greedy decoding over it, beam search with K 2 and the
in-flight batcher (3 requests on 2 lanes) over a model axis of N ranks,
and one greedy decode of 4 tokens at base.en's widths (d 512, 8 heads,
vocab 51864) over that axis. Each is held against the port's one-device
run of the same weights on the rank's own device: tokens and lengths
equal, beam scores and the train step's loss within 1e-5, its parameters
within 1e-6 where the gradient is at least ``ADAM_FLOOR``, a tenth of the
learning rate below it (Adam turns a gradient's rounding near its eps
into a step difference of a few 1e-6).

``spawn`` runs any of ``TARGETS`` in such a world: each rank writes what it
computed (numpy) to ``<out>/rank<r>.pkl`` for a parent process to compare;
a rank that fails or a world that outlives its timeout fails the call, and
every child is killed.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from whisper_trtllm_tpu_torch.config import (
    GenerationConfig,
    MeshConfig,
    RuntimeConfig,
    WhisperConfig,
)
from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
from whisper_trtllm_tpu_torch.parallel import collectives, partition
from whisper_trtllm_tpu_torch.parallel.mesh import (
    check_devices,
    initialize_distributed,
    make_mesh,
)
from whisper_trtllm_tpu_torch.utils.device import to_numpy

# a rank's wait for the others at the store and at each collective
RANK_TIMEOUT_S = 180
# |g| below which an AdamW step is dominated by the gradient's rounding
ADAM_FLOOR = 1e-6
# the directory the package lies in: the ranks run from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def testing_config(heads: int, d_model: int, ffn: int) -> WhisperConfig:
    """The JAX package's sharding tests' model (``WhisperConfig.testing``
    with 128 tokens and a forced language token) at these widths."""
    return WhisperConfig.testing(
        d_model=d_model, encoder_attention_heads=heads,
        decoder_attention_heads=heads, encoder_ffn_dim=ffn,
        decoder_ffn_dim=ffn, vocab_size=128, forced_decoder_ids=((1, 11),))


def mels(cfg: WhisperConfig, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)


def train_batch(cfg: WhisperConfig, batch: int, seed: int):
    """(mel, tokens, loss_mask): masks that differ from row to row, so the
    data ranks' target counts differ."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, 8)).astype(np.int32)
    mask = np.ones((batch, 7), np.float32)
    for i in range(batch):
        mask[i, 7 - 2 * (i % 4):] = 0.0
    return mels(cfg, batch, seed), tokens, mask


def numpy_tree(tree) -> dict:
    return {"/".join(p): to_numpy(t) for p, t in partition.leaves(tree)}


def _layout_mesh(n: int, heads: int) -> MeshConfig:
    """Both axes above 1 where ``n`` allows, the model axis as large as
    that leaves it (4 or 2, dividing ``heads``)."""
    for cand in (4, 2):
        if n % cand == 0 and heads % cand == 0 and n // cand > 1:
            return MeshConfig(n // cand, cand)
    for cand in (4, 2, 1):
        if n % cand == 0 and heads % cand == 0:
            return MeshConfig(n // cand, cand)
    raise ValueError(f"no mesh of {n} ranks divides {heads} heads")


def _assert_step_close(got: dict, want: dict, grads: dict, what: str):
    """Parameters after an AdamW step (lr 1e-4): 1e-6 where the gradient
    is at least ``ADAM_FLOOR``, 1e-5 below."""
    got, grads = dict(partition.leaves(got)), dict(partition.leaves(grads))
    for path, w in partition.leaves(want):
        tol = torch.where(grads[path].abs() >= ADAM_FLOOR, 1e-6, 1e-5)
        if bool(((got[path] - w).abs() > tol).any()):
            raise AssertionError(f"{what}: {'/'.join(path)} differs by "
                                 f"{(got[path] - w).abs().max().item()}")


def dryrun(device=None) -> str:
    """The checks of the module docstring on this rank; returns the
    summary line. Raises on the first mismatch."""
    from whisper_trtllm_tpu_torch.runtime.beam import beam_decode
    from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher
    from whisper_trtllm_tpu_torch.training import (
        loss_and_grads,
        make_train_step,
    )

    n = dist.get_world_size()
    dev = torch.device("cpu" if device == "cpu" else "cuda")
    heads = 8
    train_mesh_cfg = _layout_mesh(n, heads)
    mesh = make_mesh(train_mesh_cfg, device=dev)
    cfg = testing_config(heads, 64, 128)

    # one DP x TP train step against the one-device step
    batch = 2 * train_mesh_cfg.data
    mel, tokens, mask = train_batch(cfg, batch, 0)
    one = wmodel.init_params(cfg, seed=0, device=dev)
    _, grads = loss_and_grads(one, cfg, mel, tokens, mask)
    init, step = make_train_step(cfg)
    one, _, loss_one = step(one, init(one), mel, tokens, mask)
    sharded = partition.shard_params(wmodel.init_params(cfg, seed=0,
                                                        device=dev),
                                     mesh, cfg=cfg)
    init, step = make_train_step(cfg, mesh=mesh)
    sharded, _, loss = step(sharded, init(sharded), mel, tokens, mask)
    if abs(loss.item() - loss_one.item()) > 1e-5 * abs(loss_one.item()):
        raise AssertionError(f"train step loss {loss.item()} against "
                             f"{loss_one.item()} on one device")
    _assert_step_close(partition.gather_params(sharded), one, grads,
                       "train step")

    # greedy DP x TP decoding
    gen = GenerationConfig(max_new_tokens=8)
    infer = wmodel.init_params(cfg, seed=1, device=dev)
    ref = transcribe_tokens(infer, cfg, mel, gen, device=dev)
    with mesh:
        got = transcribe_tokens(partition.shard_params(infer, mesh, cfg=cfg),
                                cfg, mel, gen, device=dev)
    _assert_equal(got, ref, "greedy decoding")

    # the rest over a model axis of every rank
    serve_cfg = MeshConfig(1, n) if heads % n == 0 else train_mesh_cfg
    serve_mesh = make_mesh(serve_cfg, device=dev)
    serve = partition.shard_params(infer, serve_mesh, cfg=cfg)
    bgen = GenerationConfig(max_new_tokens=8, num_beams=2)
    mel_t = torch.from_numpy(mel).to(dev)
    ref = beam_decode(infer, cfg, wmodel.encode(infer, cfg, mel_t), bgen)
    with serve_mesh:
        got = beam_decode(serve, cfg, wmodel.encode(serve, cfg, mel_t), bgen)
    _assert_equal((got[0], got[2]), (ref[0], ref[2]), "beam search")
    if (got[1] - ref[1]).abs().max().item() > 1e-5:
        raise AssertionError("beam search: scores differ by more than 1e-5")

    requests = mels(cfg, 3, 7)

    def run_ifb(p):
        b = InflightBatcher(p, cfg, GenerationConfig(max_new_tokens=8),
                            num_lanes=2, segment_steps=4, device=dev)
        ids = [b.submit(m) for m in requests]
        b.run()
        return [b.fetch(i) for i in ids]

    ref = run_ifb(infer)
    with serve_mesh:
        got = run_ifb(serve)
    for a, b in zip(got, ref):
        if not np.array_equal(a, b):
            raise AssertionError("in-flight batcher: tokens differ")

    base = WhisperConfig.preset("base.en")
    base_params = wmodel.init_params(base, seed=2, device=dev)
    bmel = mels(base, 1, 0)
    pgen = GenerationConfig(max_new_tokens=4)
    ref = transcribe_tokens(base_params, base, bmel, pgen, device=dev)
    base_sharded = partition.shard_params(base_params, serve_mesh, cfg=base)
    del base_params
    with serve_mesh:
        got = transcribe_tokens(base_sharded, base, bmel, pgen, device=dev)
    _assert_equal(got, ref, "base.en greedy decoding")
    return (f"dryrun OK: {n} ranks, mesh data={train_mesh_cfg.data} "
            f"model={train_mesh_cfg.model}, one train step (loss "
            f"{loss.item():.4f}) + greedy DPxTP batch {batch}; beam K 2, "
            f"batcher 3 requests on 2 lanes and base.en greedy at "
            f"data={serve_cfg.data} model={serve_cfg.model}: all equal to "
            f"one device")


def _assert_equal(got, want, what: str) -> None:
    for g, w in zip(got, want):
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{what}: differs from one device")


def _raises(fn, kind) -> str:
    """The message of the ``kind`` ``fn`` raises, or "" when it does not."""
    try:
        fn()
    except kind as e:
        return str(e) or kind.__name__
    return ""


def serve_checks(out: dict, device="cuda", workdir: str = "") -> None:
    """The inference cases of ``tests/test_torch_parallel.py``, into
    ``out`` (numpy)."""
    from whisper_trtllm_tpu_torch import quantization
    from whisper_trtllm_tpu_torch.runtime.beam import beam_decode
    from whisper_trtllm_tpu_torch.runtime.generation import transcribe_tokens
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession

    meshes = {s: make_mesh(MeshConfig(*s), device=device)
              for s in ((4, 1), (2, 2), (1, 4))}
    cfg4 = testing_config(4, 64, 128)
    p4 = wmodel.init_params(cfg4, seed=0, device=device)
    mel8 = mels(cfg4, 8, 0)
    gen = GenerationConfig(max_new_tokens=8)

    def greedy(params, cfg, shape, mel=mel8, g=gen):
        mesh = meshes[shape]
        with mesh:
            t, n = transcribe_tokens(
                partition.shard_params(params, mesh, cfg=cfg), cfg, mel, g,
                device=device)
        return to_numpy(t), to_numpy(n)

    for shape in meshes:
        out[f"greedy {shape}"] = greedy(p4, cfg4, shape)
    fused = wmodel.fuse_qkv_params(p4)
    out["local (2, 2)"] = numpy_tree(partition.shard_params(
        p4, meshes[(2, 2)], cfg=cfg4))
    out["local fused (1, 4)"] = numpy_tree(partition.shard_params(
        fused, meshes[(1, 4)], cfg=cfg4))
    out["fused (1, 4)"] = greedy(fused, cfg4, (1, 4))
    vocab8 = quantization.quantize_vocab_embedding(p4)
    out["int8 vocab (2, 2)"] = greedy(vocab8, cfg4, (2, 2))
    sess = WhisperSession(p4, cfg4, GenerationConfig(max_new_tokens=4),
                          RuntimeConfig(weight_dtype="int8"),
                          mesh=meshes[(2, 2)], device=device)
    out["int8 session (2, 2)"] = sess.transcribe_features(mel8[:4])
    out["int8 session leaves"] = numpy_tree(sess.params)
    bsess = WhisperSession(p4, cfg4,
                           GenerationConfig(max_new_tokens=6, num_beams=2),
                           mesh=meshes[(2, 2)], device=device)
    out["beam session (2, 2)"] = bsess.transcribe_features(mel8[:4])

    for name, heads, d in (("six heads", 6, 96), ("two heads", 2, 64)):
        cfg = testing_config(heads, d, 2 * d)
        params = wmodel.init_params(cfg, seed=0, device=device)
        g6 = GenerationConfig(max_new_tokens=6)
        out[f"{name} (1, 4)"] = greedy(params, cfg, (1, 4), g=g6)
        out[f"{name} (2, 2)"] = greedy(params, cfg, (2, 2), g=g6)

    # beams over the model axis, on the local-head caches
    bgen = GenerationConfig(max_new_tokens=6, num_beams=3)
    sharded = partition.shard_params(p4, meshes[(1, 4)], cfg=cfg4)
    mel4 = torch.from_numpy(mel8[:4]).to(device)
    with meshes[(1, 4)]:
        enc = wmodel.encode(sharded, cfg4, mel4)
        out["encoder (1, 4)"] = to_numpy(enc)
        out["beam (1, 4)"] = tuple(map(to_numpy, beam_decode(
            sharded, cfg4, enc, bgen)))
        # the collectives of one encode and one decode step
        collectives.reset_counts()
        enc = wmodel.encode(sharded, cfg4, mel4[:1])
        out["encoder all-reduces"] = collectives.COUNTS["all_reduce"]
        collectives.reset_counts()
        cross = wmodel.compute_cross_kv(sharded, cfg4, enc)
        self_kv = wmodel.init_self_kv(
            cfg4, 1, 4, device=device,
            heads=partition.local_model(sharded, cfg4).decoder_heads)
        logits, _ = wmodel.decode_step_kv(
            sharded, cfg4, torch.tensor([1], dtype=torch.int32), 0, self_kv,
            cross)
        out["decoder step all-reduces"] = collectives.COUNTS["all_reduce"]
        out["first logits (1, 4)"] = to_numpy(logits)
        b = InflightBatcher(sharded, cfg4, gen, num_lanes=2, segment_steps=4,
                            device=device)
        ids = [b.submit(m) for m in mels(cfg4, 3, 7)]
        b.run()
        out["batcher (1, 4)"] = [b.fetch(i) for i in ids]

    # a sampled decode with the batch cut over a data axis: each row's noise
    # keyed by its global lane, so every cut draws the one-device tokens;
    # (2, 1) over ranks 0 and 1 only
    sgen = GenerationConfig(max_new_tokens=8, temperature=1.5, top_k=20,
                            seed=3)
    out["sampled one device"] = WhisperSession(
        p4, cfg4, sgen, device=device).transcribe_features(mel8[:4])
    mesh21 = make_mesh(MeshConfig(2, 1), device=device, devices=range(2))
    sampled = {"(4, 1)": meshes[(4, 1)], "(2, 2)": meshes[(2, 2)]}
    if mesh21.get_coordinate() is not None:
        sampled["(2, 1)"] = mesh21
    for shape, mesh in sampled.items():
        out[f"sampled {shape}"] = WhisperSession(
            p4, cfg4, sgen, mesh=mesh, device=device).transcribe_features(
            mel8[:4])

    # refusals
    with meshes[(2, 2)]:
        out["refuse batch 3 over data 2"] = _raises(
            lambda: transcribe_tokens(partition.shard_params(
                p4, meshes[(2, 2)], cfg=cfg4), cfg4, mel8[:3], gen,
                device=device), ValueError)
    out["refuse outside the mesh"] = _raises(
        lambda: transcribe_tokens(sharded, cfg4, mel8, gen, device=device),
        RuntimeError)
    out["refuse fp8"] = _raises(lambda: partition.shard_params(
        quantization.fp8_quantize(p4), meshes[(2, 2)], cfg=cfg4), ValueError)
    stats = quantization.whisper_act_stats(
        p4, cfg4, mel8[:2], np.ones((2, 4), np.int32))
    out["refuse smoothquant"] = _raises(lambda: partition.shard_params(
        quantization.smooth_quantize_whisper(p4, stats), meshes[(2, 2)],
        cfg=cfg4), ValueError)
    cfg_odd = testing_config(4, 64, 20)
    out["refuse odd int4 cut"] = _raises(lambda: partition.shard_params(
        quantization.weight_only_quantize_int4(
            wmodel.init_params(cfg_odd, seed=0, device=device)),
        meshes[(1, 4)], cfg=cfg_odd), ValueError)
    out["check_devices (2, 2)"] = check_devices(meshes[(2, 2)])
    out["check_devices (4, 1)"] = check_devices(meshes[(4, 1)])
    out["dryrun"] = dryrun(device)


def train_checks(out: dict, device="cuda", workdir: str = "") -> None:
    """The training, checkpoint and scaling cases of
    ``tests/test_torch_parallel_train.py``, into ``out`` (numpy); the DCP
    checkpoint goes to ``<workdir>/ckpt``."""
    ckpt = os.path.join(workdir, "ckpt")
    from whisper_trtllm_tpu_torch.benchmarks import scaling
    from whisper_trtllm_tpu_torch.parallel.mesh import axis_group, split_batch
    from whisper_trtllm_tpu_torch.training import (
        guided_attn_weights,
        loss_and_grads,
        make_train_step,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        load_sharded,
        save_sharded,
    )

    meshes = {s: make_mesh(MeshConfig(*s), device=device)
              for s in ((2, 2), (1, 4))}
    for name, heads, d, shape, guided in (
            ("step (2, 2)", 4, 64, (2, 2), False),
            ("guided step (2, 2)", 4, 64, (2, 2), True),
            ("six heads step (1, 4)", 6, 96, (1, 4), False)):
        cfg = testing_config(heads, d, 2 * d)
        mesh = meshes[shape]
        mel, tokens, mask = train_batch(cfg, 4, 1)
        ga = (guided_attn_weights(7, cfg.max_source_positions), 0.5) \
            if guided else (None, None)
        params = partition.shard_params(
            wmodel.init_params(cfg, seed=0, device=device), mesh, cfg=cfg)
        with mesh:
            _, grads = loss_and_grads(
                params, cfg, *(split_batch(x, mesh)
                               for x in (mel, tokens, mask)),
                *ga, data_group=axis_group(mesh, "data"))
        grads = partition.gather_params(partition.adopt(grads, params))
        init, step = make_train_step(cfg, mesh=mesh)
        params, _, loss = step(params, init(params), mel, tokens, mask, *ga)
        out[name] = (loss.item(), numpy_tree(grads),
                     numpy_tree(partition.gather_params(params)))

    cfg6 = testing_config(6, 96, 192)
    p6 = wmodel.init_params(cfg6, seed=3, device=device)
    sharded = partition.shard_params(p6, meshes[(1, 4)], cfg=cfg6)
    save_sharded(ckpt, sharded)
    back = load_sharded(ckpt, shardings=meshes[(2, 2)])
    want = partition.shard_params(p6, meshes[(2, 2)], cfg=cfg6)
    out["dcp resharded"] = (numpy_tree(back), numpy_tree(want))
    out["dcp whole"] = numpy_tree(load_sharded(ckpt, device=device))

    out["check_devices (2, 2)"] = check_devices(meshes[(2, 2)])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        scaling.main(["--model", "tiny_en", "--devices", "1", "2", "4", "8",
                      "--per-device-batch", "1", "--gen-tokens", "2",
                      "--iters", "1"] + (["--cpu"] if device == "cpu"
                                         else []))
    out["scaling"] = text.getvalue()


def dryrun_checks(out: dict, device="cuda", workdir: str = "") -> None:
    out["dryrun"] = dryrun(device)


TARGETS = {"dryrun": dryrun_checks, "serve": serve_checks,
           "train": train_checks}


def _rank_main(args) -> None:
    torch.set_num_threads(1)
    device = "cpu" if args.cpu else "cuda"
    initialize_distributed(
        device, init_method=f"file://{args.store}", world_size=args.world,
        rank=args.rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        out: dict = {}
        TARGETS[args.run](out, device, args.out)
        with open(os.path.join(args.out, f"rank{args.rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(n: int, run: str = "dryrun", workdir: str = None,
          cpu: bool = False, timeout: float = 600.0, env: dict = None) -> list:
    """Run ``run`` on a world of ``n`` rank processes (``python -m`` this
    module), their store, logs and outputs in ``workdir`` (default: a new
    temporary directory); returns each rank's pickled ``out`` dict. A rank
    that exits non-zero, or a world still running after ``timeout``
    seconds, raises with the ranks' logs; every child is killed first.
    The ranks run NCCL over the cards unless ``cpu`` (gloo on the CPU),
    in ``env`` (default: this process's environment)."""
    with (contextlib.nullcontext(workdir) if workdir
          else tempfile.TemporaryDirectory()) as tmp:
        out = tmp
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        cmd = [sys.executable, "-m",
               "whisper_trtllm_tpu_torch.parallel.dryrun",
               "--rank", "{r}", "--world", str(n), "--store",
               os.path.join(tmp, "store"), "--run", run, "--out", out]
        if cpu:
            cmd.append("--cpu")
        procs = [subprocess.Popen([c.format(r=r) for c in cmd], stdout=log,
                                  stderr=subprocess.STDOUT, cwd=_ROOT,
                                  env=env)
                 for r, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(log.read())
            log.close()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(
                f"{run} on {n} ranks failed (exit codes "
                f"{[p.returncode for p in procs]}):\n" + "\n".join(
                    f"--- rank {r}\n{t[-4000:]}" for r, t in enumerate(text)))
        results = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks of the world")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (the kernels' plain "
                    "versions); the default is NCCL, one card a rank")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--run", default="dryrun", choices=sorted(TARGETS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return
    if not args.cpu and torch.cuda.device_count() < args.n:
        raise RuntimeError(f"{args.n} ranks need {args.n} CUDA cards, "
                           f"{torch.cuda.device_count()} are visible; pass "
                           f"--cpu for gloo ranks on the CPU")
    print(spawn(args.n, "dryrun", cpu=args.cpu)[0]["dryrun"])


if __name__ == "__main__":
    main()
