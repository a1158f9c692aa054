"""Fine-tuning CLI: adapt a Whisper checkpoint on (mel, token) pairs
(counterpart of ``cli/finetune.py``).

Usage:
  python -m whisper_trtllm_tpu_torch.cli.finetune --checkpoint DIR \\
      --dataset train.pkl --output DIR [--epochs 1] [--batch 8] [--lr 1e-5] \\
      [--warmup-steps N] [--augment-mel STD] [--guided-attn SCALE] \\
      [--remat] [--save-every N] [--cpu]

The dataset pickle holds (mel (3000, M) float32, token_ids list[int]) pairs
(token ids include decoder_start and EOS). The checkpoint must hold float
weights. It runs on the CUDA card, or with ``--cpu`` on the CPU through
the kernels' plain versions. At the end it prints the kernel launches of
the run.

``--data-parallel D --model-parallel M`` (D·M above 1) trains over a
(D, M) mesh (``parallel/``) and runs under ``torchrun --nproc-per-node
D·M``: NCCL over D·M cards, gloo with ``--cpu``. Every rank reads the
dataset and draws the same batches; the train step gives each data rank
its rows of the batch and each model rank its shards of the weights. Rank
0 alone prints the epoch lines and writes the checkpoint, the whole tree
gathered from the shards.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch


def _pad_tokens(seqs, pad_id, max_len):
    out = np.full((len(seqs), max_len), pad_id, np.int32)
    mask = np.zeros((len(seqs), max_len - 1), np.float32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.int32)[:max_len]
        out[i, : len(s)] = s
        mask[i, : max(len(s) - 1, 0)] = 1.0
    return out, mask


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear warmup to --lr then cosine decay to lr/20 "
                    "over the run")
    ap.add_argument("--augment-mel", type=float, default=0.0,
                    help="per-batch gaussian noise added to the input mels "
                    "(std, in log-mel units)")
    ap.add_argument("--max-target-len", type=int, default=128)
    ap.add_argument("--guided-attn", type=float, default=0.0,
                    help="guided cross-attention loss scale (synthetic "
                    "corpus only: the monotonic alignment is known; "
                    "training/train.py::guided_attn_weights). 0 disables")
    ap.add_argument("--guided-attn-anneal", type=int, default=4,
                    help="linearly anneal the guided-attention weight to 0 "
                    "over this many epochs")
    ap.add_argument("--save-every", type=int, default=0,
                    help="also save the checkpoint every N epochs")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                    "the default is the CUDA card")
    args = ap.parse_args(argv)

    from whisper_trtllm_tpu_torch.config import MeshConfig
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shard_params,
    )
    from whisper_trtllm_tpu_torch.parallel.partition import gather_params
    from whisper_trtllm_tpu_torch.training import (
        AdamW,
        guided_attn_weights,
        make_train_step,
        warmup_cosine_decay_schedule,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from whisper_trtllm_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    world = args.data_parallel * args.model_parallel
    mesh = None
    if world > 1:
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"--data-parallel {args.data_parallel} --model-parallel "
                f"{args.model_parallel} runs under torchrun "
                f"--nproc-per-node {world}")
        initialize_distributed(device)
        mesh = make_mesh(MeshConfig(args.data_parallel, args.model_parallel),
                         device)
    lead = mesh is None or int(os.environ["RANK"]) == 0
    params, cfg = load_checkpoint(args.checkpoint, device=device)
    if mesh is not None:
        params = shard_params(params, mesh, cfg=cfg)
    with open(args.dataset, "rb") as f:
        data = pickle.load(f)

    n = len(data)
    steps_per_epoch = max((n - args.batch) // args.batch + 1, 1)
    lr = args.lr
    if args.warmup_steps > 0:
        lr = warmup_cosine_decay_schedule(
            init_value=args.lr / 100.0, peak_value=args.lr,
            warmup_steps=args.warmup_steps,
            decay_steps=max(args.epochs * steps_per_epoch,
                            args.warmup_steps + 1),
            end_value=args.lr / 20.0)
    init_opt, step = make_train_step(cfg, AdamW(lr), mesh=mesh,
                                     remat=args.remat)
    opt_state = init_opt(params)

    # on the device once, not once a step
    ga_w = (torch.from_numpy(guided_attn_weights(
        args.max_target_len - 1, cfg.max_source_positions)).to(device)
        if args.guided_attn > 0 else None)

    reset_launch_counts()
    aug_rng = np.random.default_rng(12345)
    for epoch in range(args.epochs):
        gw = args.guided_attn * max(
            0.0, 1.0 - epoch / max(args.guided_attn_anneal, 1))
        epoch_ga_w = ga_w if gw > 0 else None
        ga_scale = gw if gw > 0 else None
        perm = np.random.default_rng(epoch).permutation(n)
        losses = []
        t0 = time.time()
        for i in range(0, n - args.batch + 1, args.batch):
            idx = perm[i: i + args.batch]
            mel = np.stack([np.asarray(data[j][0], np.float32) for j in idx])
            if mel.shape[1] == cfg.num_mel_bins:      # (M, T) → (T, M)
                mel = mel.transpose(0, 2, 1)
            if args.augment_mel > 0.0:
                mel = mel + aug_rng.standard_normal(
                    mel.shape).astype(np.float32) * args.augment_mel
            tokens, mask = _pad_tokens(
                [data[j][1] for j in idx], cfg.pad_token_id,
                args.max_target_len)
            params, opt_state, loss = step(params, opt_state, mel, tokens,
                                           mask, epoch_ga_w, ga_scale)
            losses.append(float(loss))
        if lead:
            print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
                  f"({len(losses)} steps, {time.time() - t0:.1f}s"
                  + (f", guided-attn {gw:.3f}" if args.guided_attn else "")
                  + ")", flush=True)
        if args.save_every and (epoch + 1) % args.save_every == 0:
            whole = gather_params(params)
            if lead:
                save_checkpoint(args.output, whole, cfg)
                print(f"  checkpoint saved at epoch {epoch}", flush=True)

    whole = gather_params(params)
    if lead:
        save_checkpoint(args.output, whole, cfg)
        print(f"saved fine-tuned checkpoint to {args.output}")
        print("kernel launches " + json.dumps(
            {name: fn.launches for name, fn in KERNELS.items()}), flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
