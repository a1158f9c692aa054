#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``whisper_trtllm_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (a checkout of an earlier commit) builds that commit's
flash attention forward K1, decode-attention kernels K2 and K7, its STFT
frontend K3, its LayerNorm K5, its fused decoder-layer step K6 and its
bias+GELU K8 from its own ``csrc/`` and times them beside these on the
same inputs, in turns (parent, this, this, parent), as ``parent_ms`` on
their lines; without it nothing else is built.

Seven phases (and phases 2b, 2c and 5b), each timed; any failure raises and the script exits non-zero:

1. build — compiles every kernel of the main paths from ``csrc/`` with
   ``nvcc`` for sm_90a (one ``nvcc`` per source, all at once: eight
   sources) and, beside them, the serving path's native library
   ``libwtpu.so`` from ``cpp/`` with ``g++``, and prints the build time,
   ``nvcc``'s register/spill report and the card's name and power limit;
2. kernels — holds each kernel against its plain PyTorch version on the
   card at the main paths' shapes, in fp32 and bf16 (and, from a random
   stream of their own, at the bench's: flash attention, the quantized
   decode attention and LayerNorm at tiny.en's batch 32 and medium.en's
   and large-v3's batch 16, the STFT frontend at batch 32, the fused
   decoder-layer step at the benchmark grid's batch 1 and 8; decode attention
   also with int8 and fp8 caches, both cache layouts and per-lane valid
   lengths, its cross case at batch 4 and 32, each line with its split
   plan and the blocks it launches; the fused decoder-layer step over a
   sweep of positions; the flash backward at the encoder's, the training
   cross attention's, a causal and a GQA shape; the head-contiguous cross
   attention at the hardware check's shape over valid lengths 1500, 1 and
   T, at batch 4 and 32; the example's bias+GELU at its (512, 384) and at
   the encoder MLP's (6000, 1536); and, from a third stream, the beam
   phase's 16 lanes: the quantized decode attention, the decode step's
   LayerNorm and the fused decoder-layer step; and from a fourth, the
   decode attention at the in-flight batcher's shape, 8 lanes at lengths
   1..225 in one launch, float and int8 caches, fp32 q; and the zoo's:
   K1 causal at 800 positions at gpt_350m's heads and llama_7b's, 32
   heads over 32 and over 8 key/value heads, GPT-J's 16 heads of 256 and
   GPT-NeoX's 64 of 96, K2 at the zoo's steps (GPT-J's heads of 256 and
   GPT-NeoX's of 96 among them), K5 at the zoo's widths 4096, 6144, 9216
   and 12288 over a prefill's rows (2 x 800) and a decode step's (2); K2
   with ALiBi's bias at bloom_560m's step, float fp32 and bf16, one count
   and one a lane, int8 T-minor and fp8, an all-zero bias bit-equal to
   none, SDPA with the same float mask its library time); and phase 2c's:
   K1 at SD-1.x's UNet attentions (B 2, H 8: self at S = T = 4096, 1024
   and 256, cross at those S over T = 77 context rows, at head dims 40,
   80 and 160) and BERT-large's (B 8, H 16, 512 positions); every
   input drawn on the card by a CUDA generator seeded from the check's
   own tag (``CardRng``), K3 held to its plain version's formula in
   float64 (the witness), and times the kernel, the plain
   version and, where one exists, one PyTorch library call computing the
   same function (the yardstick; the port never calls it), and the launch
   floor: PyTorch's spin kernel given nothing to do,
   ``torch.cuda._sleep(0)``, the least time one launch takes;
2b. zoo (right after phase 2) — the causal-LM zoo's generation path (``runtime/causal_lm.py``,
   ``runtime/beam_lm.py``) on weights from ``init_params(seed=0)`` drawn
   on the host beside the kernels phase: gpt_350m at full width and depth
   (24 layers, d 1024, vocabulary 51200) in fp32, lockstep greedy at
   batch 4 from a prompt of 800 (K1 in the prefill) and of 32 (no K1),
   ragged at lengths 800/790/780/770 (each lane equal to its own lockstep
   run at batch 1), a repetition penalty with a bad and a stop word, a
   sampled call (its seed twice equal, another seed otherwise),
   p-tuning with a prompt table of 2 tasks, beams K 4 at batch 2, and a
   bf16 lockstep call (printed, not gated); opt_350m's widths cut to 2
   layers (the time limit's cut), lockstep and ragged;
   llama_7b's widths cut to 2 layers, lockstep at batch 2 from 800 and
   beams, and the same widths with 8 key/value heads (GQA in K1 and in
   the step); gptj_6b's and gptneox_20b's widths cut to 2 layers (heads
   of 256 and of 96, K5 at 4096 and 6144), lockstep at batch 2 from 800,
   ragged at 800/790 and beams K 2 from 32; bloom_560m at full width and
   depth (24 layers, ALiBi's bias in every step's K2) lockstep at batch 4
   from 800, bf16 (printed), ragged at 800..770, a sampled seed twice and
   beams K 4 at batch 2; chatglm_6b's widths cut to 2 layers (vocabulary
   130528) lockstep at batch 2 from 800 (the [gMASK] at 798), ragged at
   800/790, a sampled seed twice and beams K 2. Every call's launches are
   exact over the steps it ran (K1 a layer for a prompt past 768 but none
   in Bloom's or ChatGLM's prefill, K2 a layer a step, K5 2L + 1 a
   prefill and a step for GPT, OPT, GPT-NeoX and ChatGLM, 2L + 2 for
   Bloom, L + 1 for GPT-J, none for LLaMA), with one capture and
   then replays, and a repeat call that only replays and gives the same
   outputs; a gpt_350m call from the long prompt (8 new tokens), and
   GPT-J's, GPT-NeoX's, Bloom's and ChatGLM's, count what the profiler
   counts over them.
   Lane 0 of
   each greedy call equals the argmax of the port's teacher-forced
   ``forward`` on the CPU over the card's sequence (the rules applied for
   the rule-bound call), a step whose CPU top-two gap lies under
   ``ZOO_GAP`` of max |logit| ending the comparison; beam scores within
   ``ZOO_BEAM_SCORE_TOLERANCE`` of the CPU's beams. Then ``bench_zoo``
   (``benchmarks/benchmark.py --model gpt_350m``, one row) and
   ``cli/run_zoo.py --family gpt``, ``bloom`` and ``chatglm6b`` as
   subprocesses (their tokens against the CPU's argmax). Each call's ms,
   its capture's and the
   prefill's, and a repeat's ms a step are printed;
2c. zoo runtimes (right after 2b, on 2b's host trees and two more drawn
   beside the kernels phase) — gpt_350m at full width and depth through
   the in-flight batcher (``runtime/ifb_lm.py``) and the paged one
   (``runtime/ifb_paged.py``, its pool at 16 tokens a block holding 160
   blocks against the dense equivalent's 208): 4 lanes, prompts padded to
   800 (every admit runs K1), 32 new tokens, 8 requests of 770..800
   tokens in two waves of 4 (the paged batcher's fourth admit of a wave
   waits on blocks, checked); each step captured once when the batcher is
   built, then replays only; launches exact from the steps run and the
   admits (a step K2 L, K5 2L + 1; an admit K1 L, K5 2L + 1), equal to the
   profiler's over a traced drain of two more; the paged rows equal the
   dense ones, every block back after ``run()``, each request its
   batch-1 lockstep ``generate`` (or the CPU's argmax up to a near tie);
   a replayed step's ms, paged against dense. Then ``paged_beam_search``
   (``runtime/beam_paged.py``, K 4 from a block-aligned prompt of 800, 32
   new, eager steps): tokens and lengths equal to the dense beam search's
   on the card, scores within ``ZOO_BEAM_SCORE_TOLERANCE``, every block
   released, launches exact. BERT-large whole (``models/bert``) at batch
   8 x 512, fp32 and bf16, unmasked (K1 24, K5 49 a forward) and masked
   (K1 0); row 0 in fp32, and a masked row, against the port's CPU forward
   on that sequence within ``BERT_TOLERANCE``; ``bench_zoo bert_large`` as
   a subprocess. The UNet at SD-1.x's widths and depth (``models/unet``)
   at batch 2 over 64x64 latents and 77 context rows, fp32 and bf16: K1
   32 and K5 48 a forward (two and three a Transformer2D block, counted
   from the tree), a repeat call equal, the first sample in fp32 against
   the port's CPU forward at batch 1 within ``UNET_TOLERANCE`` of max
   |CPU|; the CPU's references run in a thread beside the card's calls;
3. hardware check and example — runs ``python -m
   whisper_trtllm_tpu_torch.cli.gpu_check`` (every check of the port's
   counterpart of ``cli/tpu_check.py``, among them K7's
   ``cross_attn_kernel``) and the custom-kernel example's ``main()`` (K8)
   as subprocesses: each must exit 0 with every check passing, and each
   reports the launches of its kernel;
4. end to end — loads the trained tiny.en artifact and transcribes the
   four bundled utterances as one batch through
   ``WhisperSession.transcribe`` in thirteen configurations: A fp32 with float
   KV caches; B bf16 with int8 KV, cross cache T-minor ("auto"), the
   serving precision; C fp32 with int8 KV, cross cache dh-minor ("bhtd");
   D bf16 with fp8 KV ("auto"); and on the float tree (the artifact
   dequantized in memory): E fp32 and F bf16 with float KV, whose decode
   steps run the fused decoder-layer kernel, and G, the float tree through
   the session's load-time chain (bf16, int8 weights, int8 vocab table,
   fused q/k/v, int8 KV), whose int8 tensors must be bit-equal to the
   artifact's. Each must give the exact texts of ``artifacts/expected.json``
   and the expected launch count of every kernel, counted from zero over
   that one transcribe; A, C and E must give the same tokens as the plain
   path on the CPU. Then the weight modes on the float tree, each in fp32
   (float KV, dh-minor) and bf16 (int8 KV, "auto"): I int4 and J fp8 QDQ
   through the session's chain, K SmoothQuant calibrated on the card
   (its stats within ``STATS_RTOL`` of the CPU's); before them
   SmoothQuant's integer product at ``INT_MM_ROWS`` rows, the fp8 cast,
   the fp8 QDQ, SmoothQuant's per-token int8 and the int4 unpack are held
   bit-equal to the CPU's. Each gives the four texts, its quantized
   tensors bit-equal to the port's quantizer run on the CPU, launches
   exact with no K6; I32 the CPU's tokens, J32 and K32 their share of
   them and the first step's largest logit gap; transcribe and decode ms. Every decode goes through the captured CUDA graph of
   the step (``runtime/generation.py``): the launch counts take the loop's
   steps (the warm-up step, then the replays, up to
   ``FINISH_CHECK_EVERY - 1`` past the last EOS). A, B and E are timed
   stage by stage, with the host µs of a step replayed and run eagerly,
   the card's idle share over an untraced transcribe (one traced
   transcribe's device time over the median untraced one), whose trace
   must hold as many launches of K2, K5 and K6 as the counters say, and
   for E the host cost of K6's gate, once a decode call. Then the decode
   features, on E (each greedy variant token-equal to the CPU's) and B:
   timestamps, a prompted decode, bad and stop words, min-new-tokens, and
   a sampled decode (one draw a seed; ``SAMPLED_AGREEMENT`` of its tokens
   equal to the CPU's in E). Then beam search (``runtime/beam.py``, K =
   ``BEAM_K`` = 4 at batch 4) through the session, in E (B·K = 16 lanes:
   K6) and B (K2): the best hypotheses give the expected texts, launch
   counts exact from the loop's steps (one warm-up step and one capture,
   then a repeat transcribe that only replays, its counters equal to the
   profiler's), and in E every hypothesis and ``beam_decode_prompted``
   token-equal to the CPU's, scores within ``BEAM_SCORE_TOLERANCE``; and
   ``transcribe_long_conditioned`` in E over the four utterances in one
   44.6 s stream (two chunks), greedy and K = 2, per-chunk ids equal to
   the CPU's; then speculative decoding (``runtime/speculative.py``, each
   utterance at batch 1 from its audio, the round a captured CUDA graph):
   S1 the artifact as its own draft at gamma 2 and 4 (the 4 texts, tokens
   equal to the card's greedy, tokens and stats equal to the CPU's and to
   the JAX package's, ``SPEC_SELF``; a repeat that only replays), S2 the
   float tree against a random draft whose steps run K6 (the 4 texts, 0
   accepted, launches exact from the stats and equal to the profiler's),
   S3 batch-1 ms against greedy and ``benchmarks/spec_loop_cost.py``'s ms
   a round (ungated); then the CLIs and engine export
   (``clis_and_engine``, subprocesses side by side): C1 ``cli.transcribe``
   at batch 4 in fp32 and B, its ids the session's, the 4 texts, WER 0.0;
   C2 engines at batch 4 in B and E loaded and run in fresh interpreters
   that cannot import the model code, tokens the session's (and a seed-1
   tree's a session's on it), launches equal to the session's and the
   profiler's, one capture; the same for beam engines (K 4 in B, K 2 in
   E), the best hypothesis the session's and the 4 texts; and a process
   that exports before decoding
   transcribes C1's tokens; C3 ``cli.warm_cache`` builds every library
   into an empty directory, and a session with ``persistent_cache_dir``
   there runs no ``nvcc``; C4 B with each inert option; C5
   ``encode_with_intermediates``, ``checked``, ``cli.visualize``; C6 the
   toy acceptance loop (``synthetic_asr`` make, ``finetune``,
   ``export-hf``, ``accept``: differential 1.0);
5. training — on the float tree with the bundled batch of 4 and their
   ground-truth tokens (32 positions): (a) the loss and every leaf's
   gradient on the card against the CPU's (each nonzero), and one
   ``make_train_step`` step with exact K1, K4 and K5 launch counts; (b)
   three steps at lr 1e-4 on the same mels with the transcripts rotated
   by one utterance (a batch the trained model has not fit: on its own
   transcripts it sits at the minimum, and Adam's first step moves every
   weight by ~lr), whose loss must fall, timed, with the peak device
   memory; (c) ``python -m whisper_trtllm_tpu_torch.cli.finetune``
   for 3 epochs with ``--remat --guided-attn 1`` on a pickle of the same
   batch, with exact launch counts, its checkpoint reloaded;
5b. parallel — ``torch.distributed`` with NCCL at a world of one (the
   machine has one card, and NCCL takes one rank a card): ``check_devices``
   over a 1×1 mesh, the NCCL version; ``WhisperSession(mesh=...)`` in A
   and B, the 4 texts, tokens and launches equal to the one-device
   session's, no collective issued; a sampled session in A over the mesh
   (each row's draw keyed by its global lane) token-equal to the
   one-device one; one ``make_train_step(mesh=...)`` step
   on the float tree, its loss and parameters equal to the one-device
   step's; ``save_sharded``/``load_sharded`` round-tripping that tree
   bit-equal onto the card; ``benchmarks/scaling.py --devices 1`` under
   ``torchrun --nproc-per-node 1`` (one row, efficiency 1.0); K1, K4 and
   K2's cross case at the head counts a rank holds when tensor parallelism
   cuts the published sizes (``LOCAL_HEADS``: 1, 3 and 5) against their
   plain versions, timed, and each of the three called with no heads,
   launching nothing. A model or data axis above 1 is not run here: the
   CPU tests hold those against the JAX package;
6. bench — runs ``python -m whisper_trtllm_tpu_torch.cli.bench --fp32``
   (tiny.en at batch 32, medium.en and large-v3 at batch 16; its gate reads
   the record phase 3 wrote) and ``python -m
   whisper_trtllm_tpu_torch.benchmarks.benchmark --model tiny.en --batch 1
   8 --dtype float32 bfloat16`` as subprocesses and prints their lines: the
   gate must pass, every number be finite and positive, MFU and each
   section's decode roofline share at most 1.05, both sections present,
   and each grid row must show K6 once a decode layer; the grid's beam
   row (``--num-beams 4``, tiny.en bf16 batch 8, 32 lanes a step) beside
   its greedy twin, with exact launch counts, and in this process its ms
   a step, host µs a replay, idle share, peak memory and the cache
   reorder's share of a step; then one headline pass in this process
   with exact K1, K2, K3 and K5 launch counts and no K6, the headline
   batch's stages timed one by one with the host µs of a step, and the card's idle
   share: the device time of one pass under ``torch.profiler`` over the
   median wall time of three passes not traced;
7. serving — (a) the in-flight batcher (``runtime/ifb.py``, 2 lanes, its
   step captured once when it is built) in process on the artifact in A,
   C, int8 KV T-minor ("auto") and E: the 4 utterances drained at once and
   staggered (two, one segment, two more) give the 4 texts; a
   double-buffered batcher the same ids; in A, C and E the ids equal the
   CPU batcher's and the card's lockstep session's; the launches exact
   over the steps the segments ran (K2 2 and K5 3 a layer + 1 a step, no
   K6; K3 once, K1 once and K5 twice an encoder layer + 1 a request),
   equal to the profiler's on a traced drain, and replays only after the
   one capture; (b) ``python -m whisper_trtllm_tpu_torch.cli.serve`` as a
   subprocess for the slots, ifb and sched backends (int8 KV): the 4 WAVs
   POSTed at once give the 4 texts, a malformed WAV 400; (c) the load
   harness (``benchmarks/serve_loadtest.py``: 16 clients, 64 requests
   over the 4 WAVs, 32 new tokens) on the ifb and slots backends, and in
   process the batcher as ``cli.serve`` builds it (8 lanes, 16 steps a
   segment) over a drain of 64 requests: host µs a segment, segments a
   drain, and the idle share (a traced drain's device time over the
   median of three untraced).

The line before the last is one JSON object with every ported kernel's
numbers (K1's, K4's and K5's also in bf16, under "bfloat16"; K5's decode
step under "decode", K8's (6000, 1536) under "encoder_mlp", both with the
launch floor as "floor_ms"; the bench path's launches as "bench_launches",
the beam path's first transcribe's (B; E for K6) as "beam_launches",
the in-flight batcher's first drain in int8-auto as "serve_launches",
one speculative utterance (S1 at gamma 4; S2 for K6) as "spec_launches";
K2's batcher shape under "batcher"; K1's, K2's and K4's rows at the local
head counts under "local_heads"; K1's, K2's and K5's at the zoo's shapes
under "zoo", and gpt_350m's lockstep call at prompt 800 as "zoo_launches",
GPT-J's, GPT-NeoX's, Bloom's and ChatGLM's at theirs under
"zoo_launches_gptj", "zoo_launches_gptneox", "zoo_launches_bloom" and
"zoo_launches_chatglm6b"; phase 2c's as "zoo_launches_ifb" and
"zoo_launches_ifb_paged" (each batcher's two waves), "zoo_launches_beam_paged",
"zoo_launches_bert" (one unmasked fp32 forward) and "zoo_launches_unet"
(one forward); K2's rows with a bias under "bias");
the last is ``{"ok": true, "device":
{...}}``. Without a CUDA
card, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "tiny_en_synth_int8")
EVAL_DIR = os.path.join(ROOT, "artifacts", "eval")
SEED = 0
DEVICE = "cuda"

# H100 SXM published peaks (dense): device memory bytes/s and flop/s by the
# inputs' type — fp32 outside the tensor cores, bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# K1 and K4 take fp32 products on the tensor cores as 3xTF32: each operand
# split into two tf32 halves and three tf32 products (flash_tiles.cuh), so
# their fp32 peak is a third of the 495 TFLOP/s TF32 rate, not the FMA
# units' 67 (which a share above 100% would otherwise read against)
FLASH_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# fp32: the kernel reorders sums (online softmax, lane-group dots, warp
# shuffles); bf16: the plain decode attention rounds the softmax weights to
# bf16 before P·V, and a bf16 LayerNorm output may round the other way (one
# bf16 step, checked relative to max(|plain|, 1))
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
# log10-mel values of K3 against the plain version's formula in float64:
# the JAX package's STFT tolerance (fp32 DFT sums, amplified by log10 near
# the floor)
STFT_TOLERANCE = 2e-4
SOURCES = ["flash_attention", "flash_attention_bwd", "decode_attention",
           "decode_attention_bias",
           "stft", "layer_norm", "fused_decoder_step", "cross_attention",
           "fused_bias_gelu"]
# the fused decoder-layer step: fp32 sums over up to 1536 terms in another
# order (atol and rtol); bf16 relative to max(|plain|, 1), one bf16 step
FUSED_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
L2_BYTES = 50e6
# a spin of the card (torch.cuda._sleep) that the host queues timed work
# behind: 2e8 cycles, about 0.1 s at a 2 GHz clock
SPIN_CYCLES = 200_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, dtype_name: str, peaks=PEAK_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peaks[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, cycling through
    ``arg_sets`` so that the inputs of one launch are not in L2 from the
    last, as in the decode loop where other layers' caches pass between.

    The calls are queued behind a spin of the card, so the events time the
    card's work and not the host's: a wrapper's host time can exceed a
    short kernel's, and then a loop's pace is the host's. Where the host
    cannot queue them all before the spin ends (a plain version of many
    small ops fills the launch queue), the calls are halved until it
    can."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        queued = not start.query()  # the spin outlasted the queueing
        torch.cuda.synchronize()
        if queued or iters == 1:
            return start.elapsed_time(end) / iters
        iters //= 2


class CardRng:
    """The kernel checks' normals, drawn on the card by a CUDA generator
    seeded from ``SEED`` and the check's tag: each check's inputs depend on
    its own draws only, whatever the checks before it drew (numpy draws
    ~55 M values a second on the host). ``standard_normal`` takes numpy's
    arguments and returns an fp32 tensor on the card."""

    def __init__(self, torch, tag: str):
        import zlib

        self.torch = torch
        self.gen = torch.Generator(device=DEVICE)
        self.gen.manual_seed(SEED * 2 ** 32 + zlib.crc32(tag.encode()))

    def standard_normal(self, shape, dtype="float32"):
        return self.torch.randn(shape, generator=self.gen, device=DEVICE)


def card_tensor(torch, x, dtype=None):
    """``x`` (a tensor or a numpy array) on the card, in ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x)
    return x.to(DEVICE, dtype)


def n_sets(set_bytes: float) -> int:
    return max(2, min(8, math.ceil(2 * L2_BYTES / set_bytes)))


def time_beside(torch, fn, parent_fn, arg_sets, iters: int):
    """(ms, parent_ms): ``fn`` timed as ``time_ms`` does and, where
    ``parent_fn`` (an earlier commit's kernel, ``--parent``) is given, the
    two in turns, parent, this, this, parent, each the mean of its two
    timings; parent_ms is None without one."""
    if parent_fn is None:
        return time_ms(torch, fn, arg_sets, iters), None
    p1 = time_ms(torch, parent_fn, arg_sets, iters)
    m1 = time_ms(torch, fn, arg_sets, iters)
    m2 = time_ms(torch, fn, arg_sets, iters)
    p2 = time_ms(torch, parent_fn, arg_sets, iters)
    return (m1 + m2) / 2, (p1 + p2) / 2


def parent_note(parent_ms) -> str:
    return "" if parent_ms is None else f"parent_ms={parent_ms:.4f} "


def load_parent(root: str) -> dict:
    """K1's, K2's, K3's, K5's, K6's, K7's and K8's wrappers from the checkout of
    another commit at ``root``, built from its own ``csrc/`` into its own
    ``build/`` by its own ``_build``, so that the same calls time both.
    Their launch counts are their own."""
    import importlib.util

    from whisper_trtllm_tpu_torch.ops.kernels import _build as own_build

    package = os.path.join(os.path.abspath(root), "whisper_trtllm_tpu_torch")
    kernels = os.path.join(package, "ops", "kernels")

    def load(name, folder=kernels, **attrs):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", os.path.join(folder, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        # a wrapper module registers its torch.ops.wtpu operator when it is
        # imported (through this package's _build, which it imports by
        # name), and these names are taken: the parent's eager wrappers
        # launch without them
        define_op = own_build.define_op
        own_build.define_op = lambda *args: None
        try:
            spec.loader.exec_module(mod)
        finally:
            own_build.define_op = define_op
        for key, value in attrs.items():
            setattr(mod, key, value)  # its functions look it up at call time
        return mod

    build = load("_build")
    t0 = time.perf_counter()
    build.build(["flash_attention", "decode_attention", "cross_attention",
                 "stft", "layer_norm", "fused_decoder_step",
                 "fused_bias_gelu"])
    print(f"parent: built K1, K2, K3, K5, K6, K7 and K8 from {kernels} in "
          f"{time.perf_counter() - t0:.2f} s")
    return {"flash_fwd": load("flash_attention", _build=build).flash_fwd,
            "decode_attn": load("decode_attention", _build=build).decode_attn,
            "cross_decode_mha": load("cross_attention",
                                     _build=build).cross_decode_mha,
            "stft_log_mel": load("stft", _build=build).stft_log_mel,
            "layer_norm": load("layer_norm", _build=build).layer_norm,
            "fused_decoder_layer_step": load(
                "fused_decoder_step", _build=build).fused_decoder_layer_step,
            "fused_bias_gelu": load(
                "custom_gelu_kernel",
                os.path.join(package, "examples", "custom_kernel"),
                _build=build).fused_bias_gelu}


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

FLASH_CASES = [  # (name, B, H, Hkv, S=T, dh, causal)
    ("encoder", 4, 6, 6, 1500, 64, False),
    ("gqa", 4, 6, 2, 1500, 64, False),
    ("causal", 4, 6, 6, 1500, 64, True),
    ("dh128", 1, 2, 2, 300, 128, False),
]
# the bench's encoders: tiny.en at batch 32, medium.en and large-v3 at 16
BENCH_FLASH_CASES = [("encoder", 32, 6, 6, 1500, 64, False),
                     ("encoder", 16, 16, 16, 1500, 64, False),
                     ("encoder", 16, 20, 20, 1500, 64, False)]
# the zoo phase's causal prefills: gpt_350m and opt_350m at batch 4, the
# 2-layer llama_7b widths at batch 2, its 32 heads over 32 and over 8
# key/value heads, 800 positions
ZOO_FLASH_CASES = [("zoo gpt", 4, 16, 16, 800, 64, True),
                   ("zoo llama", 2, 32, 32, 800, 128, True),
                   ("zoo llama gqa", 2, 32, 8, 800, 128, True)]
# GPT-J's prefill (16 heads of 256) and GPT-NeoX-20B's (64 heads of 96) at
# batch 2, 800 positions: K1 past 128 and at a head width padded to 128
ZOO_WIDE_FLASH_CASES = [("zoo gptj", 2, 16, 16, 800, 256, True),
                        ("zoo gptneox", 2, 64, 64, 800, 96, True)]
# SD-1.x's UNet at batch 2 over 64x64 latents, 8 heads: the self attention
# (S = T = H*W) and the cross attention over 77 context rows (S != T, T a
# multiple of no tile) at head dims 40, 80 and 160 (320, 640 and 1280
# channels); BERT-large's encoder at batch 8 over 512 positions. A case of
# eight fields carries T after S
UNET_FLASH_CASES = [("zoo unet self dh40", 2, 8, 8, 4096, 40, False),
                    ("zoo unet self dh80", 2, 8, 8, 1024, 80, False),
                    ("zoo unet self dh160", 2, 8, 8, 256, 160, False),
                    ("zoo unet cross dh40", 2, 8, 8, 4096, 40, False, 77),
                    ("zoo unet cross dh80", 2, 8, 8, 1024, 80, False, 77),
                    ("zoo unet cross dh160", 2, 8, 8, 256, 160, False, 77),
                    ("zoo bert_large", 8, 16, 16, 512, 64, False)]


def check_flash(torch, rng, card, cases=FLASH_CASES, parent=None):
    """K1 at ``cases``, timed beside the ``parent``'s K1 where one is given;
    returns the batch-4 encoder's numbers (fp32, the bf16 ones under
    "bfloat16"), or the zoo cases' by name and dtype, None where ``cases``
    has neither."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        attention_reference,
        flash_fwd,
    )

    headline = None
    for case in cases:
        name, b, h, hkv, s, dh, causal = case[:7]
        t = case[7] if len(case) > 7 else s
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            set_bytes = (2 * b * h * s * dh + 2 * b * hkv * t * dh) * item
            sets = []
            for _ in range(n_sets(set_bytes)):
                q = rng.standard_normal((b, h, s, dh), dtype="float32") / math.sqrt(dh)
                k = rng.standard_normal((b, hkv, t, dh), dtype="float32")
                v = rng.standard_normal((b, hkv, t, dh), dtype="float32")
                sets.append(tuple(card_tensor(torch, x, dtype)
                                  for x in (q, k, v)))
            q, k, v = sets[0]
            out = flash_fwd(q, k, v, causal=causal)
            ref = attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not math.isfinite(err) or err > TOLERANCE[dn]:
                fail(f"flash_fwd {name} {dn}: max |kernel - plain| = {err} "
                     f"> {TOLERANCE[dn]}")
            iters = 20
            ms, p_ms = time_beside(
                torch, lambda q, k, v: flash_fwd(q, k, v, causal=causal),
                parent and (lambda q, k, v: parent["flash_fwd"](
                    q, k, v, causal=causal)), sets, iters)
            plain = time_ms(torch, lambda q, k, v: attention_reference(
                q, k, v, causal=causal), sets, iters)
            lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, scale=1.0, is_causal=causal, enable_gqa=hkv != h),
                sets, iters)
            pairs = s * (s + 1) / 2 if causal else s * t
            flops = 4.0 * b * h * pairs * dh
            nbytes = set_bytes
            b_ms, b_by = bound(nbytes, flops, dn, FLASH_PEAK_FLOPS)
            lengths = f"S=T={s}" if s == t else f"S={s} T={t}"
            print(f"kernel flash_fwd {name} {dn} B={b} H={h} Hkv={hkv} "
                  f"{lengths} dh={dh} causal={causal}: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE[dn]}) ms={ms:.4f} {parent_note(p_ms)}"
                  f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            if (name, b) == ("encoder", 4):
                if dtype == torch.float32:
                    headline = row
                else:
                    headline["bfloat16"] = row
            elif name.startswith("zoo"):
                if headline is None:
                    headline = {}
                headline.setdefault(name, {})[dn] = row
            del sets
    return headline


def _split_note(q, cache_k, t_major):
    """The split plan of a K2 call: splits a (batch, head), rows a chunk,
    blocks launched (one cluster of ``splits`` blocks a head)."""
    from whisper_trtllm_tpu_torch.ops.kernels.decode_attention import (
        decode_plan,
    )

    splits, chunk, _, _ = decode_plan(q, cache_k, t_major)
    blocks = splits * q.shape[0] * q.shape[1]
    return f"splits={splits} chunk={chunk} blocks={blocks}"


def check_decode(torch, rng, card, parent=None):
    """K2 with float caches: the self-attention sweep at T 33 (batch 4, and
    the full cache at batch 32) and the cross case at T 1504, 1500 valid,
    at batch 4 (the bundled utterances) and 32 (the serving batch), each
    timed beside the ``parent``'s K2 where one is given. Returns the
    batch-4 cross case's numbers, fp32 with the bf16 ones under
    "bfloat16"."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    h, dh = 6, 64
    cases = [  # (name, B, T, valid lengths checked, valid length timed)
        ("self", 4, 33, list(range(1, 34)), 33),
        ("self", 32, 33, [33], 33),
        ("cross", 4, 1504, [1500], 1500),
        ("cross", 32, 1504, [1500], 1500),
    ]
    headline = None
    for name, b, t, sweep, vl_timed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            sets = []
            for _ in range(n_sets(2 * b * h * t * dh * item)):
                q = rng.standard_normal((b, h, 1, dh), dtype="float32") / math.sqrt(dh)
                k = rng.standard_normal((b, h, t, dh), dtype="float32")
                v = rng.standard_normal((b, h, t, dh), dtype="float32")
                sets.append(tuple(card_tensor(torch, x, dtype)
                                  for x in (q, k, v)))
            q, k, v = sets[0]
            err = 0.0
            for vl in sweep:
                vlt = torch.tensor(vl, dtype=torch.int32, device=DEVICE)
                out = decode_attn(q, k, v, vlt)
                ref = decode_attention_reference(q, k, v, vlt)
                torch.cuda.synchronize()
                e = (out.float() - ref.float()).abs().max().item()
                if not math.isfinite(e) or e > TOLERANCE[dn]:
                    fail(f"decode_attn {name} B={b} {dn} valid_len={vl}: "
                         f"max |kernel - plain| = {e} > {TOLERANCE[dn]}")
                err = max(err, e)
            vlt = torch.tensor(vl_timed, dtype=torch.int32, device=DEVICE)
            iters = 200
            ms, p_ms = time_beside(
                torch, lambda q, k, v: decode_attn(q, k, v, vlt),
                parent and (lambda q, k, v: parent["decode_attn"](
                    q, k, v, vlt)),
                sets, iters)
            plain = time_ms(torch, lambda q, k, v: decode_attention_reference(
                q, k, v, vlt), sets, iters)
            lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k[:, :, :vl_timed], v[:, :, :vl_timed], scale=1.0),
                sets, iters)
            flops = 4.0 * b * h * vl_timed * dh
            nbytes = (2 * b * h * dh + 2 * b * h * vl_timed * dh) * item + 4
            b_ms, b_by = bound(nbytes, flops, dn)
            print(f"kernel decode_attn {name} {dn} B={b} H={h} T={t} dh={dh} "
                  f"valid_len={sweep[0]}..{sweep[-1]} "
                  f"{_split_note(q, k, False)}: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE[dn]}) at valid_len={vl_timed}: "
                  f"ms={ms:.4f} {parent_note(p_ms)}plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"[{card}]")
            if name == "cross" and b == 4:
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib)
                if dtype == torch.float32:
                    headline = row
                else:
                    headline["bfloat16"] = row
    return headline


# the zoo phase's steps, float caches in q's dtype: (name, B, H, T, dh,
# valid lengths a lane at the timed step): gpt_350m's last step at batch 4
# (800 + 64 rows), its ragged lanes, its beams (B·K 8, 32 + 64 rows), the
# 2-layer llama_7b's last step at batch 2 (800 + 32 rows, the cache
# repeated to 32 heads)
ZOO_DECODE_CASES = [("gpt step", 4, 16, 864, 64, [864] * 4),
                    ("gpt ragged", 4, 16, 864, 64, [864, 854, 844, 834]),
                    ("gpt beam", 8, 16, 96, 64, [96] * 8),
                    ("llama step", 2, 32, 832, 128, [832] * 2)]
# GPT-J's last step at batch 2 (800 + 32 rows, 16 heads of 256) and
# GPT-NeoX-20B's (64 heads of 96)
ZOO_WIDE_DECODE_CASES = [("gptj step", 2, 16, 832, 256, [832] * 2),
                         ("gptneox step", 2, 64, 832, 96, [832] * 2)]


def check_decode_zoo(torch, rng, card, cases=ZOO_DECODE_CASES):
    """K2 at the zoo's step shapes (``cases``), fp32 and bf16, with a
    per-lane valid length; timed beside SDPA over the same rows (a boolean
    mask past each lane's length). Returns the rows by case name and
    dtype."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    rows_out = {}
    for name, b, h, t, dh, lens in cases:
        vlt = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        mask = (torch.arange(t, device=DEVICE)[None, :]
                < vlt[:, None])[:, None, None, :]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            sets = []
            for _ in range(n_sets(2 * b * h * t * dh * item)):
                q = rng.standard_normal((b, h, 1, dh)) / math.sqrt(dh)
                k = rng.standard_normal((b, h, t, dh))
                v = rng.standard_normal((b, h, t, dh))
                sets.append(tuple(card_tensor(torch, x, dtype)
                                  for x in (q, k, v)))
            out = decode_attn(*sets[0], vlt)
            ref = decode_attention_reference(*sets[0], vlt)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not math.isfinite(err) or err > TOLERANCE[dn]:
                fail(f"decode_attn {name} {dn}: max |kernel - plain| = "
                     f"{err} > {TOLERANCE[dn]}")
            ms = time_ms(torch, lambda q, k, v: decode_attn(q, k, v, vlt),
                         sets, 200)
            plain = time_ms(torch, lambda q, k, v: decode_attention_reference(
                q, k, v, vlt), sets, 200)
            lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0), sets, 200)
            rows = h * sum(lens)
            nbytes = 2 * b * h * dh * item + 2 * rows * dh * item + 4 * b
            b_ms, b_by = bound(nbytes, 4.0 * rows * dh, dn)
            print(f"kernel decode_attn {name} {dn} B={b} H={h} T={t} dh={dh} "
                  f"valid_len={lens} {_split_note(sets[0][0], sets[0][1], False)}"
                  f": max_abs_err={err:.3e} (tol {TOLERANCE[dn]}) "
                  f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            rows_out.setdefault(name, {})[dn] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)
            del sets
    return rows_out


# K2 with ALiBi's additive bias at bloom_560m's last step of the zoo phase
# (batch 4, 16 heads of 64, 800 + 64 rows): (name, lens a lane, cache kind,
# T-minor); fp32 and bf16 q for the float rows, fp32 q for the quantized
# ones. ChatGLM-6B's step (B 2, 32 heads of 128, 832 rows) takes K2 without
# a bias: ZOO_DECODE_CASES' "llama step" row is that shape.
BIAS_CASES = [("bloom step", [864] * 4, None, False),
              ("bloom ragged", [864, 854, 844, 834], None, False),
              ("bloom ragged int8", [864, 854, 844, 834], "int8", True),
              ("bloom ragged fp8", [864, 854, 844, 834], "fp8", False)]
BIAS_SHAPE = (4, 16, 864, 64)  # B, H, T, dh


def check_decode_bias(torch, rng, card, cases=BIAS_CASES):
    """K2 with an additive score bias (``BIAS_CASES``): each case held to
    its plain version at ``TOLERANCE``; the same inputs with an all-zero
    bias bit-equal to no bias; ms, the plain version's and, for the float
    rows, SDPA with the same float ``attn_mask`` (the bias, -inf past each
    lane's length), and the bound. Returns the rows by case and dtype."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.attention import quantize_kv
    from whisper_trtllm_tpu_torch.ops.functional import alibi_bias
    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    b, h, t, dh = BIAS_SHAPE
    bias = alibi_bias(h, t, DEVICE)
    zero = torch.zeros_like(bias)
    kinds = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
    rows_out = {}
    for name, lens, kind, t_major in cases:
        vlt = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        if len(set(lens)) == 1:
            vlt = vlt[0]  # one count for the batch
        past = torch.arange(t, device=DEVICE)[None, :] >= torch.tensor(
            lens, device=DEVICE)[:, None]
        mask = bias + torch.where(past, -math.inf, 0.0)[:, None, None, :]
        for dtype in ((torch.float32,) if kind else (torch.float32,
                                                     torch.bfloat16)):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            sets = []
            for _ in range(n_sets(2 * b * h * t * dh * item)):
                q = card_tensor(torch, rng.standard_normal(
                    (b, h, 1, dh)) / math.sqrt(dh), dtype)
                k = rng.standard_normal((b, h, t, dh))
                v = rng.standard_normal((b, h, t, dh))
                if kind is None:
                    sets.append((q, card_tensor(torch, k, dtype),
                                 card_tensor(torch, v, dtype), None, None))
                    continue
                kq, ks = quantize_kv(card_tensor(torch, k), kinds[kind])
                vq, vs = quantize_kv(card_tensor(torch, v), kinds[kind])
                if t_major:
                    kq = kq.transpose(-1, -2).contiguous()
                    vq = vq.transpose(-1, -2).contiguous()
                sets.append((q, kq, vq, ks, vs))
            q, k, v, ks, vs = sets[0]
            out = decode_attn(q, k, v, vlt, ks, vs, t_major, bias)
            ref = decode_attention_reference(q, k, v, vlt, k_scale=ks,
                                             v_scale=vs, t_major=t_major,
                                             bias=bias)
            none = decode_attn(q, k, v, vlt, ks, vs, t_major)
            zeroed = decode_attn(q, k, v, vlt, ks, vs, t_major, zero)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not math.isfinite(err) or err > TOLERANCE[dn]:
                fail(f"decode_attn bias {name} {dn}: max |kernel - plain| = "
                     f"{err} > {TOLERANCE[dn]}")
            if not torch.equal(none, zeroed):
                fail(f"decode_attn bias {name} {dn}: an all-zero bias is not "
                     f"bit-equal to no bias")
            ms = time_ms(torch, lambda q, k, v, ks, vs: decode_attn(
                q, k, v, vlt, ks, vs, t_major, bias), sets, 200)
            plain = time_ms(torch, lambda q, k, v, ks, vs:
                            decode_attention_reference(
                                q, k, v, vlt, k_scale=ks, v_scale=vs,
                                t_major=t_major, bias=bias), sets, 200)
            lib = None if kind else time_ms(
                torch, lambda q, k, v, ks, vs: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask.to(q.dtype), scale=1.0), sets, 200)
            rows = h * sum(lens)
            # q and out in q's dtype; the rows read (1-byte values and two
            # fp32 scales when quantized); the bias once; the lengths
            row_bytes = dh + 4 if kind else dh * item
            nbytes = (2 * b * h * dh * item + 2 * rows * row_bytes
                      + 4 * h * t + 4 * b)
            b_ms, b_by = bound(nbytes, 4.0 * rows * dh, "float32"
                               if kind else dn)
            lib_note = "none" if lib is None else f"{lib:.4f}"
            print(f"kernel decode_attn bias {name} {kind or 'float'} "
                  f"{'bhdt' if t_major else 'bhtd'} q={dn} B={b} H={h} T={t} "
                  f"dh={dh} valid_len={lens} "
                  f"{_split_note(q, k, t_major)}: max_abs_err={err:.3e} (tol "
                  f"{TOLERANCE[dn]}), zero bias bit-equal to none: ms={ms:.4f}"
                  f" plain_ms={plain:.4f} library_ms={lib_note} (SDPA, float "
                  f"mask) bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            rows_out.setdefault(name, {})[dn] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)
            del sets
    return rows_out


# (name, B, H, T, valid lengths checked, valid length timed): a per-lane
# sweep, lane i reading (v + 9 i) mod 34 rows, v = 0..33, so that every
# lane meets every length 0..33 (0: the uniform softmax); the full cache at
# batch 32; the cross case at batch 4 and 32
QUANT_CASES = [("self", 4, 6, 33, [[(v + 9 * i) % 34 for i in range(4)]
                                   for v in range(34)], [33] * 4),
               ("self", 32, 6, 33, [[33] * 32], [33] * 32),
               ("cross", 4, 6, 1504, [1500], 1500),
               ("cross", 32, 6, 1504, [1500], 1500)]
# the bench's: its self caches of 49 rows (48 tokens) and its cross caches
# at tiny.en's batch 32 and medium.en's and large-v3's batch 16
BENCH_QUANT_CASES = [("self", 32, 6, 49, [[49] * 32], [49] * 32),
                     ("self", 16, 20, 49, [[49] * 16], [49] * 16),
                     ("cross", 16, 16, 1504, [1500], 1500),
                     ("cross", 16, 20, 1504, [1500], 1500)]

# the beam phase's, B·K = 16 lanes (batch 4, K 4): the self cache of 33
# rows (32 tokens) and the tiled cross cache
BEAM_QUANT_CASES = [("self", 16, 6, 33, [[33] * 16], [33] * 16),
                    ("cross", 16, 6, 1504, [1500], 1500)]


def check_decode_quant(torch, rng, card, parent=None, cases=QUANT_CASES):
    """K2 with int8/fp8 caches (scales folded in), both cache layouts, fp32
    and bf16 q: a per-lane valid_len sweep at the self-attention shape
    (batch 4; the full cache at batch 32) and the scalar cross case at
    batch 4 and 32 (``QUANT_CASES``), or the bench's (``BENCH_QUANT_CASES``).
    No single PyTorch call computes it: no library time.
    Each case is timed beside the ``parent``'s K2 where one is given.
    Returns the serving precision's numbers (int8 T-minor cache, bf16 q,
    the batch-4 cross case)."""
    from whisper_trtllm_tpu_torch.ops.attention import quantize_kv
    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    dh = 64
    kinds = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
    serving = None
    for name, b, h, t, sweep, vl_timed in cases:
        for kind, qdt in kinds.items():
            for t_major in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    dn = str(dtype).split(".")[1]
                    item = torch.tensor([], dtype=dtype).element_size()
                    sets = []
                    for _ in range(n_sets(2 * b * h * t * (dh + 4))):
                        q = rng.standard_normal((b, h, 1, dh), dtype="float32") / math.sqrt(dh)
                        k = rng.standard_normal((b, h, t, dh), dtype="float32")
                        v = rng.standard_normal((b, h, t, dh), dtype="float32")
                        kq, ks = quantize_kv(card_tensor(torch, k), qdt)
                        vq, vs = quantize_kv(card_tensor(torch, v), qdt)
                        if t_major:
                            kq = kq.transpose(-1, -2).contiguous()
                            vq = vq.transpose(-1, -2).contiguous()
                        sets.append((card_tensor(torch, q, dtype),
                                     kq, vq, ks, vs))
                    q, kq, vq, ks, vs = sets[0]
                    err = 0.0
                    for vl in sweep:
                        vlt = torch.tensor(vl, dtype=torch.int32, device=DEVICE)
                        out = decode_attn(q, kq, vq, vlt, ks, vs, t_major)
                        ref = decode_attention_reference(
                            q, kq, vq, vlt, k_scale=ks, v_scale=vs,
                            t_major=t_major)
                        torch.cuda.synchronize()
                        e = (out.float() - ref.float()).abs().max().item()
                        if not math.isfinite(e) or e > TOLERANCE[dn]:
                            fail(f"decode_attn {name} B={b} {kind} "
                                 f"t_major={t_major} {dn} valid_len={vl}: "
                                 f"max |kernel - plain| = {e} > "
                                 f"{TOLERANCE[dn]}")
                        err = max(err, e)
                    vlt = torch.tensor(vl_timed, dtype=torch.int32, device=DEVICE)
                    ms, p_ms = time_beside(
                        torch, lambda q, k, v, ks, vs: decode_attn(
                            q, k, v, vlt, ks, vs, t_major),
                        parent and (lambda q, k, v, ks, vs: parent[
                            "decode_attn"](q, k, v, vlt, ks, vs, t_major)),
                        sets, 200)
                    plain = time_ms(torch, lambda q, k, v, ks, vs:
                                    decode_attention_reference(
                                        q, k, v, vlt, k_scale=ks, v_scale=vs,
                                        t_major=t_major), sets, 200)
                    rows = b * h * (vl_timed if isinstance(vl_timed, int)
                                    else vl_timed[0])
                    flops = 4.0 * rows * dh
                    # q and out in q's dtype, 1-byte values and fp32 scales
                    # of the rows read, the valid lengths
                    nbytes = 2 * b * h * dh * item + 2 * rows * (dh + 4) + 4 * b
                    # the arithmetic is fp32 whatever q's dtype
                    b_ms, b_by = bound(nbytes, flops, "float32")
                    print(f"kernel decode_attn {name} {kind} "
                          f"{'bhdt' if t_major else 'bhtd'} q={dn} B={b} H={h} "
                          f"T={t} dh={dh} {_split_note(q, kq, t_major)} "
                          f"{len(sweep)} valid_len sets: "
                          f"max_abs_err={err:.3e} (tol {TOLERANCE[dn]}) at "
                          f"valid_len={vl_timed if isinstance(vl_timed, int) else vl_timed[0]}: "
                          f"ms={ms:.4f} {parent_note(p_ms)}"
                          f"plain_ms={plain:.4f} library_ms=none "
                          f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
                    if (name, b, kind, t_major, dn) == (
                            "cross", 4, "int8", True, "bfloat16"):
                        serving = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=None)
                    del sets
    return serving


# (batch, mels): the bundled batch's frontend at tiny.en's 80 mels and at
# large-v3's 128; the bench's: the headline's batch of 32 utterances
STFT_CASES = [(4, 80), (4, 128)]
BENCH_STFT_CASES = [(32, 80)]


def check_stft(torch, rng, card, parent=None, cases=STFT_CASES):
    """K3 at the frontend's shapes, 3003 blocks of 160 samples, half of one
    utterance silent (``STFT_CASES``, or the bench's ``BENCH_STFT_CASES``);
    timed beside the ``parent``'s K3 where one is given. The kernel is held
    to the plain version's formula run in float64 (the witness), within
    ``STFT_TOLERANCE``: the plain version in fp32 is the farther of the two
    from the witness where they part by more than the limit (PERF.md §6;
    ``benchmarks/stft_witness.py``), so |kernel - plain| is printed beside
    it, not gated. Returns the batch-4, 80-mel numbers, None where
    ``cases`` has no such case."""
    from whisper_trtllm_tpu_torch.audio.features import (
        HOP_LENGTH,
        N_FFT,
        LogMelSpectrogram,
    )
    from whisper_trtllm_tpu_torch.benchmarks.stft_witness import (
        stft_log_mel_witness,
    )
    from whisper_trtllm_tpu_torch.ops.kernels import (
        stft_log_mel,
        stft_log_mel_reference,
    )

    n_blocks = 3003
    headline = None
    for b, n_mels in cases:
        fe = LogMelSpectrogram(n_mels, device=DEVICE)
        basis, mel_fb = fe.dft_basis[:N_FFT], fe.mel_fb
        sets = []
        for _ in range(n_sets(b * n_blocks * HOP_LENGTH * 4)):
            x = rng.standard_normal((b, n_blocks, HOP_LENGTH), dtype="float32") * 0.1
            x[1, n_blocks // 2:] = 0.0  # silence: power at the 1e-10 floor
            sets.append((card_tensor(torch, x),))
        out = stft_log_mel(sets[0][0], basis, mel_fb)
        ref = stft_log_mel_reference(sets[0][0], basis, mel_fb)
        wit = stft_log_mel_witness(sets[0][0], basis, mel_fb)
        torch.cuda.synchronize()
        err = (out - wit).abs().max().item()
        plain_err = (ref - wit).abs().max().item()
        kp = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > STFT_TOLERANCE:
            fail(f"stft_log_mel B={b} M={n_mels}: max |kernel - witness| = "
                 f"{err} > {STFT_TOLERANCE}")
        ms, p_ms = time_beside(
            torch, lambda x: stft_log_mel(x, basis, mel_fb),
            parent and (lambda x: parent["stft_log_mel"](x, basis, mel_fb)),
            sets, 20)
        plain = time_ms(torch, lambda x: stft_log_mel_reference(x, basis, mel_fb),
                        sets, 20)
        n_frames, n_bins = n_blocks - 2, basis.shape[1] // 2
        # the DFT and the mel product run on the tensor cores as 3xTF32 (a
        # third of the TF32 rate), power on the fp32 units: the times add
        products = 2.0 * b * n_frames * n_bins * (N_FFT * 2 + n_mels)
        power = 3.0 * b * n_frames * n_bins
        t_ops = (products / FLASH_PEAK_FLOPS["float32"]
                 + power / PEAK_FLOPS["float32"])
        nbytes = 4 * (b * n_blocks * HOP_LENGTH + basis.numel()
                      + mel_fb.numel() + b * n_frames * n_mels)
        t_bytes = nbytes / HBM_BYTES_PER_S
        b_ms = max(t_ops, t_bytes) * 1e3
        b_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"kernel stft_log_mel B={b} blocks={n_blocks}x{HOP_LENGTH} "
              f"taps={N_FFT} M={n_mels} float32: max_abs_err={err:.3e} "
              f"against the fp64 witness (tol {STFT_TOLERANCE}; plain fp32 "
              f"{plain_err:.3e} from it, |kernel - plain| {kp:.3e}) "
              f"ms={ms:.4f} {parent_note(p_ms)}"
              f"plain_ms={plain:.4f} library_ms=none bound_ms={b_ms:.4f} "
              f"({b_by}) [{card}]")
        if (b, n_mels) == (4, 80):
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return headline


def launch_floor(torch, card) -> float:
    """The least time one launch takes on the card: PyTorch's spin kernel
    given nothing to do, timed as every kernel is."""
    ms = time_ms(torch, lambda: torch.cuda._sleep(0), [()], 200)
    print(f"launch floor: torch.cuda._sleep(0) ms={ms:.4f} [{card}]")
    return ms


# (name, x's shape): the bundled batch's encoder and decode rows at tiny.en's
# width; the bench's: tiny.en at batch 32, medium.en and large-v3 at 16
NORM_CASES = [("encoder", (4, 1500, 384)), ("decode", (4, 1, 384))]
BENCH_NORM_CASES = [("encoder", (32, 1500, 384)), ("decode", (32, 1, 384)),
                    ("encoder", (16, 1500, 1024)), ("decode", (16, 1, 1024)),
                    ("encoder", (16, 1500, 1280)), ("decode", (16, 1, 1280))]
# the beam phase's decode rows, B·K = 16 lanes
BEAM_NORM_CASES = [("decode", (16, 1, 384))]
# the zoo's widths past 2048 (a block a row): GPT-J's 4096, GPT-NeoX-20B's
# 6144, opt_66b's 9216 and gpt_175b's 12288, over a prefill's rows (batch
# 2, 800 positions) and a decode step's (batch 2)
ZOO_NORM_CASES = [(f"zoo {kind} d{d}", (2, s, d)) for d in (4096, 6144, 9216,
                                                           12288)
                  for kind, s in (("prefill", 800), ("decode", 1))]


def check_layer_norm(torch, rng, card, floor_ms, parent=None,
                     cases=NORM_CASES):
    """K5 at the encoder's rows (batch 4) and the decode step's, both
    dtypes, with and without bias (``NORM_CASES``), or at the bench's
    (``BENCH_NORM_CASES``) or the zoo's (``ZOO_NORM_CASES``); timed beside
    the ``parent``'s K5 where one is given. Returns the encoder's fp32
    numbers, with its bf16 ones under "bfloat16" and the decode step's
    under "decode"; or the zoo cases' by name and dtype."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        layer_norm,
        layer_norm_reference,
    )
    from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import norm_plan

    headline = None
    for name, shape in cases:
        d = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            rows = shape[0] * shape[1]
            sets = []
            for _ in range(n_sets(2 * rows * d * item)):
                x = rng.standard_normal(shape, dtype="float32") * 2 + 0.5
                g = 1 + 0.1 * rng.standard_normal(d, dtype="float32")
                bb = 0.1 * rng.standard_normal(d, dtype="float32")
                sets.append(tuple(card_tensor(torch, a, dtype)
                                  for a in (x, g, bb)))
            x, g, bb = sets[0]
            err = 0.0
            for bias in (bb, None):
                out = layer_norm(x, g, bias)
                ref = layer_norm_reference(x, g, bias)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                e = (diff / ref.float().abs().clamp(min=1)).max().item()
                if not math.isfinite(e) or e > TOLERANCE[dn]:
                    fail(f"layer_norm {name} {dn} bias={bias is not None}: "
                         f"max |kernel - plain| / max(|plain|, 1) = {e} > "
                         f"{TOLERANCE[dn]}")
                err = max(err, diff.max().item())
            iters = 200
            ms, p_ms = time_beside(torch, layer_norm,
                                   parent and parent["layer_norm"], sets,
                                   iters)
            plain = time_ms(torch, layer_norm_reference, sets, iters)
            lib = time_ms(torch, lambda x, g, bb: F.layer_norm(
                x, (d,), g, bb, 1e-5), sets, iters)
            nbytes = (2 * rows * d + 2 * d) * item
            b_ms, b_by = bound(nbytes, 8.0 * rows * d, "float32")
            plan = norm_plan(rows, d, item, True)
            print(f"kernel layer_norm {name} {dn} rows={rows} d={d} "
                  f"vec={plan.vec} lanes_a_row={plan.lpr} "
                  f"vectors_a_lane={plan.vpt} blocks<={plan.blocks}x"
                  f"{plan.threads}: max_abs_err={err:.3e} (tol "
                  f"{TOLERANCE[dn]} of max(|plain|, 1)) ms={ms:.4f} "
                  f"{parent_note(p_ms)}plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.6f} ({b_by}) "
                  f"floor_ms={floor_ms:.4f} [{card}]")
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib)
            if name == "encoder" and dtype == torch.float32:
                headline = row
            elif name == "encoder":
                headline["bfloat16"] = row
            elif name.startswith("zoo"):
                headline = headline or {}
                headline.setdefault(name, {})[dn] = row
            elif headline is not None:
                headline.setdefault("decode", {})[dn] = row
    return headline


# (batch, self cache rows, positions checked; the last is timed): the
# bundled batch's 17 steps; the benchmark grid's float rows, batch 1 and 8
# (its 8 rows fill the kernel's 8-row padding), 48 steps
FUSED_CASES = [(4, 33, (0, 16, 32))]
BENCH_FUSED_CASES = [(1, 49, (0, 24, 48)), (8, 49, (0, 24, 48))]
# the beam phase's E: B·K = 16 lanes, the kernel's largest batch
BEAM_FUSED_CASES = [(16, 33, (0, 16, 32))]


def check_fused(torch, rng, card, parent=None, cases=FUSED_CASES):
    """K6 at tiny.en's decoder-layer shapes, over ``cases`` (or the bench's
    ``BENCH_FUSED_CASES``): a self cache swept over positions, a cross
    cache of 1504 rows of which 1500 are valid; timed beside the
    ``parent``'s K6 where one is given. No single PyTorch call computes it:
    no library time. Returns the batch-4 fp32 numbers, None where ``cases``
    has no batch 4."""
    from whisper_trtllm_tpu_torch.ops.kernels import (
        fused_decoder_layer_step,
        fused_decoder_layer_step_reference,
    )
    from whisper_trtllm_tpu_torch.ops.kernels.fused_decoder_step import PHASES

    d, h, ffn, tc, enc_len = 384, 6, 1536, 1504, 1500
    dh = d // h
    headline = None
    for (b, ts, positions), dtype in itertools.product(
            cases, (torch.float32, torch.bfloat16)):
        dn = str(dtype).split(".")[1]
        item = torch.tensor([], dtype=dtype).element_size()
        weights = 4 * d * d + 2 * d * ffn
        params = 2 * (5 * d + ffn)  # biases and LayerNorm scales, biases
        set_bytes = (weights + params + 2 * b * h * (ts + tc) * dh) * item

        def tensor(shape, scale):
            x = rng.standard_normal(shape, dtype="float32") * scale
            return card_tensor(torch, x, dtype)

        def dense(din, dout):
            return {"kernel": tensor((din, dout), din ** -0.5),
                    "bias": tensor((dout,), 0.1)}

        def norm():
            return {"scale": 1 + tensor((d,), 0.1), "bias": tensor((d,), 0.1)}

        sets = []
        for _ in range(n_sets(set_bytes)):
            lp = {"self_attn": {"q": dense(d, d), "out": dense(d, d)},
                  "encoder_attn": {"q": dense(d, d), "out": dense(d, d)},
                  "encoder_attn_layer_norm": norm(),
                  "final_layer_norm": norm(),
                  "fc1": dense(d, ffn), "fc2": dense(ffn, d)}
            caches = [tensor((b, h, t, dh), s)
                      for t, s in ((ts, 0.3), (ts, 1.0), (tc, 0.3), (tc, 1.0))]
            sets.append((tensor((b, d), 1.0), tensor((b, d), 1.0), lp, caches))
        el = torch.tensor(enc_len, dtype=torch.int32, device=DEVICE)
        tol = FUSED_TOLERANCE[dn]
        x, h1, lp, caches = sets[0]
        err = 0.0
        for pos in positions:
            pt = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
            out = fused_decoder_layer_step(x, h1, pt, lp, *caches, el)
            ref = fused_decoder_layer_step_reference(x, h1, pt, lp, *caches, el)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                bad = (diff > tol + tol * ref.float().abs()).any().item()
            else:
                bad = (diff / ref.float().abs().clamp(min=1)).max().item() > tol
            e = diff.max().item()
            if not math.isfinite(e) or bad:
                fail(f"fused_decoder_layer_step {dn} B={b} pos={pos}: max |kernel - "
                     f"plain| = {e} beyond its tolerance {tol}")
            err = max(err, e)
        pos = positions[-1]
        pt = torch.tensor(pos, dtype=torch.int32, device=DEVICE)
        ms, p_ms = time_beside(
            torch, lambda x, h1, lp, c: fused_decoder_layer_step(
                x, h1, pt, lp, *c, el),
            parent and (lambda x, h1, lp, c: parent["fused_decoder_layer_step"](
                x, h1, pt, lp, *c, el)), sets, 200)
        plain = time_ms(torch, lambda x, h1, lp, c:
                        fused_decoder_layer_step_reference(
                            x, h1, pt, lp, *c, el), sets, 50)
        # where a launch's time goes: the boundaries of its phases on the
        # card's global timer, as the first block sees them, mean of 50
        timeline = torch.zeros(len(PHASES) + 1, dtype=torch.int64,
                               device=DEVICE)
        marks = []
        for i in range(50):
            x, h1, lp, c = sets[i % len(sets)]
            fused_decoder_layer_step(x, h1, pt, lp, *c, el, timeline=timeline)
            marks.append(timeline.diff().double().cpu())
        phase_us = (torch.stack(marks).mean(0) / 1e3).tolist()
        print(f"kernel fused_decoder_layer_step {dn} B={b} phases (us, mean of 50, "
              f"{len(PHASES) - 1} waits) [{card}]: "
              + ", ".join(f"{n} {t:.2f}" for n, t in zip(PHASES, phase_us)))
        # this run's work: the self rows t <= pos and the cross rows
        # t < enc_len are read, the rest of the caches is not
        rows = pos + 1 + enc_len
        nbytes = (weights + params + 2 * b * h * rows * dh + 3 * b * d) * item + 8
        flops = 2.0 * b * weights + 4.0 * b * h * rows * dh
        # the arithmetic is fp32 FMAs whatever the storage dtype
        b_ms, b_by = bound(nbytes, flops, "float32")
        print(f"kernel fused_decoder_layer_step {dn} B={b} d={d} H={h} dh={dh} "
              f"ffn={ffn} Ts={ts} Tc={tc} enc_len={enc_len} pos="
              f"{','.join(map(str, positions))}: max_abs_err={err:.3e} (tol "
              f"{tol}) at pos={pos}: ms={ms:.4f} {parent_note(p_ms)}"
              f"plain_ms={plain:.4f} "
              f"library_ms=none bound_ms={b_ms:.4f} ({b_by}) [{card}]")
        if (b, dtype) == (4, torch.float32):
            headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return headline


def check_flash_bwd(torch, rng, card):
    """K4 against its plain backward, the forward's log-sum-exp from
    K1. fp32: 1e-5 of max(max|plain|, 1) (sums reordered); bf16: 2e-2
    of max(|plain|, 1) elementwise (dq rounds to bf16 from sums taken in
    another order). The library yardstick is the backward of
    ``F.scaled_dot_product_attention`` through autograd."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        flash_attention_backward_reference,
        flash_bwd,
        flash_fwd,
    )

    cases = [  # (name, B, H, Hkv, S, T, dh, causal)
        ("encoder", 4, 6, 6, 1500, 1500, 64, False),
        ("cross", 4, 6, 6, 31, 1500, 64, False),
        ("causal", 4, 6, 6, 1024, 1024, 64, True),
        ("gqa", 4, 6, 2, 1500, 1500, 64, False),
    ]
    headline = None
    for name, b, h, hkv, s, t, dh, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            # read q, k, v, dO and the fp32 lse; write dq, dk, dv
            nbytes = ((3 * b * h * s * dh + 4 * b * hkv * t * dh) * item
                      + 4 * b * h * s)
            sets = []
            for _ in range(n_sets(nbytes)):
                q = rng.standard_normal((b, h, s, dh), dtype="float32") / math.sqrt(dh)
                k = rng.standard_normal((b, hkv, t, dh), dtype="float32")
                v = rng.standard_normal((b, hkv, t, dh), dtype="float32")
                do = rng.standard_normal((b, h, s, dh), dtype="float32")
                q, k, v, do = (card_tensor(torch, x, dtype)
                               for x in (q, k, v, do))
                _, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
                sets.append((q, k, v, lse, do))
            q, k, v, lse, do = sets[0]
            got = flash_bwd(q, k, v, lse, do, causal=causal)
            ref = flash_attention_backward_reference(q, k, v, do,
                                                     causal=causal)
            torch.cuda.synchronize()
            err = 0.0
            for what, g, r in zip(("dq", "dk", "dv"), got, ref):
                diff = (g.float() - r.float()).abs()
                e = diff.max().item()
                if dtype == torch.float32:
                    bad = e > TOLERANCE[dn] * max(r.abs().max().item(), 1.0)
                else:
                    rel = (diff / r.float().abs().clamp(min=1)).max().item()
                    bad = rel > TOLERANCE[dn]
                if not math.isfinite(e) or bad:
                    fail(f"flash_bwd {name} {dn} {what}: max |kernel - "
                         f"plain| = {e} beyond its tolerance {TOLERANCE[dn]}")
                err = max(err, e)
            iters = 10
            ms = time_ms(torch, lambda q, k, v, lse, do: flash_bwd(
                q, k, v, lse, do, causal=causal), sets, iters)
            plain = time_ms(torch, lambda q, k, v, lse, do:
                            flash_attention_backward_reference(
                                q, k, v, do, causal=causal), sets, iters)
            lib_sets = []
            for q, k, v, _, do in sets:
                leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
                o = F.scaled_dot_product_attention(
                    *leaves, scale=1.0, is_causal=causal,
                    enable_gqa=hkv != h)
                lib_sets.append((o, leaves, do))
            lib = time_ms(torch, lambda o, leaves, do: torch.autograd.grad(
                o, leaves, do, retain_graph=True), lib_sets, iters)
            pairs = s * (s + 1) / 2 if causal else s * t
            # the function: the scores recomputed, then dP, dq, dk, dv
            flops = 10.0 * b * h * pairs * dh
            b_ms, b_by = bound(nbytes, flops, dn, FLASH_PEAK_FLOPS)
            print(f"kernel flash_bwd {name} {dn} B={b} H={h} Hkv={hkv} S={s} "
                  f"T={t} dh={dh} causal={causal}: max_abs_err={err:.3e} "
                  f"(tol {TOLERANCE[dn]}) ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"[{card}]")
            if name == "encoder":
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib)
                if dtype == torch.float32:
                    headline = row
                else:
                    headline["bfloat16"] = row
            del sets, lib_sets
    return headline


def check_cross(torch, rng, card, parent=None):
    """K7 at the hardware check's shape (``cli/tpu_check.py:360``: B 4,
    H 6, dh 64, T 1504), head-contiguous (B, T, H*dh), over valid lengths
    1500 (timed), 1 and T, and at the serving batch of 32; each timed
    beside the ``parent``'s K7 where one is given. The yardstick is SDPA
    on the (B, H, T, dh) views of the same cache sliced to the valid rows.
    Returns the batch-4 fp32 numbers."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.kernels import (
        cross_decode_mha,
        cross_decode_mha_reference,
    )
    from whisper_trtllm_tpu_torch.ops.kernels.cross_attention import (
        cross_plan,
    )

    h, t, dh = 6, 1504, 64
    sweep, vl_timed = (1500, 1, t), 1500
    headline = None
    for b in (4, 32):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            sets = []
            for _ in range(n_sets(2 * b * t * h * dh * item)):
                q = rng.standard_normal((b, h * dh), dtype="float32") / math.sqrt(dh)
                k = rng.standard_normal((b, t, h * dh), dtype="float32")
                v = rng.standard_normal((b, t, h * dh), dtype="float32")
                sets.append(tuple(card_tensor(torch, x, dtype)
                                  for x in (q, k, v)))
            q, k, v = sets[0]
            err = 0.0
            for vl in sweep:
                out = cross_decode_mha(q, k, v, h, dh, vl)
                ref = cross_decode_mha_reference(q, k, v, h, dh, vl)
                torch.cuda.synchronize()
                e = (out.float() - ref.float()).abs().max().item()
                if not math.isfinite(e) or e > TOLERANCE[dn]:
                    fail(f"cross_decode_mha B={b} {dn} valid_len={vl}: max "
                         f"|kernel - plain| = {e} > {TOLERANCE[dn]}")
                err = max(err, e)
            iters = 200
            ms, p_ms = time_beside(
                torch, lambda q, k, v: cross_decode_mha(q, k, v, h, dh,
                                                        vl_timed),
                parent and (lambda q, k, v: parent["cross_decode_mha"](
                    q, k, v, h, dh, vl_timed)), sets, iters)
            plain = time_ms(torch, lambda q, k, v: cross_decode_mha_reference(
                q, k, v, h, dh, vl_timed), sets, iters)

            def heads(x, b=b):  # (B, T, H*dh) -> the (B, H, T, dh) view
                return x.view(b, -1, h, dh).transpose(1, 2)

            lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
                heads(q[:, None]), heads(k)[:, :, :vl_timed],
                heads(v)[:, :, :vl_timed], scale=1.0), sets, iters)
            # q and out, then the valid rows of K and V once each
            nbytes = (2 * b * h * dh + 2 * b * vl_timed * h * dh) * item
            # the arithmetic is fp32 whatever the storage dtype
            b_ms, b_by = bound(nbytes, 4.0 * b * h * vl_timed * dh, "float32")
            splits, chunk, _, _ = cross_plan(q, h, dh, t, vl_timed)
            print(f"kernel cross_decode_mha {dn} B={b} H={h} T={t} dh={dh} "
                  f"valid_len={','.join(map(str, sweep))} splits={splits} "
                  f"chunk={chunk} blocks={splits * b * h}: "
                  f"max_abs_err={err:.3e} (tol {TOLERANCE[dn]}) at "
                  f"valid_len={vl_timed}: ms={ms:.4f} {parent_note(p_ms)}"
                  f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by}, {nbytes} bytes) [{card}]")
            if b == 4 and dtype == torch.float32:
                headline = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            del sets
    return headline


def check_gelu(torch, rng, card, floor_ms, parent=None):
    """K8 at its example's (512, 384) and at the encoder MLP's fc1 output
    at batch 4, (6000, 1536), where bandwidth and not the launch sets the
    pace; timed beside the ``parent``'s K8 where one is given. The
    yardstick is two PyTorch calls, ``F.gelu(x + bias)``: no single call
    computes it. Returns the example's fp32 numbers, the other shape's
    under "encoder_mlp"."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel \
        import fused_bias_gelu, fused_bias_gelu_reference, gelu_plan

    headline = None
    for (rows, d), dtype in [(s, t) for s in ((512, 384), (6000, 1536))
                             for t in (torch.float32, torch.bfloat16)]:
        dn = str(dtype).split(".")[1]
        item = torch.tensor([], dtype=dtype).element_size()
        sets = []
        for _ in range(n_sets(2 * rows * d * item)):
            x = rng.standard_normal((rows, d), dtype="float32")
            bias = rng.standard_normal(d, dtype="float32")
            sets.append((card_tensor(torch, x, dtype),
                         card_tensor(torch, bias, dtype)))
        out = fused_bias_gelu(*sets[0])
        ref = fused_bias_gelu_reference(*sets[0])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not math.isfinite(err) or err > TOLERANCE[dn]:
            fail(f"fused_bias_gelu {dn} x=({rows}, {d}): max |kernel - "
                 f"plain| = {err} > {TOLERANCE[dn]}")
        iters = 200
        ms, p_ms = time_beside(torch, fused_bias_gelu,
                               parent and parent["fused_bias_gelu"], sets,
                               iters)
        plain = time_ms(torch, fused_bias_gelu_reference, sets, iters)
        lib = time_ms(torch, lambda x, bias: F.gelu(x + bias), sets, iters)
        nbytes = (2 * rows * d + d) * item
        # ~20 fp32 operations an element for the add and the exact GELU
        b_ms, b_by = bound(nbytes, 20.0 * rows * d, "float32")
        plan = gelu_plan(rows, d, item, True)
        print(f"kernel fused_bias_gelu {dn} x=({rows}, {d}) vec={plan.vec} "
              f"block={plan.tx}x{plan.ty} vectors_a_thread={plan.cpt} "
              f"blocks<={plan.blocks}x{plan.chunks}: max_abs_err={err:.3e} "
              f"(tol {TOLERANCE[dn]}) ms={ms:.4f} {parent_note(p_ms)}"
              f"plain_ms={plain:.4f} library_ms={lib:.4f} (two calls: "
              f"add, F.gelu) bound_ms={b_ms:.5f} ({b_by}, {nbytes} bytes) "
              f"floor_ms={floor_ms:.4f} [{card}]")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib)
        if (rows, dtype) == (512, torch.float32):
            headline = row
        elif rows == 6000:
            headline.setdefault("encoder_mlp", {})[dn] = row
    return headline


# --------------------------------------------------------------------------
# phase 3: the hardware check and the custom-kernel example
# --------------------------------------------------------------------------

def run_module(module: str, timeout: int, args=()):
    """``python -m module args`` from the repository's root; fails the run
    unless it exits 0. Returns its standard output and its wall seconds."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{module} exited {out.returncode}:\n{out.stdout[-4000:]}\n"
             f"{out.stderr[-4000:]}")
    return out.stdout, wall


def hardware_check(card):
    """Runs ``cli.gpu_check`` and the K8 example; returns the launches of
    K7 in ``cross_attn_kernel`` and of K8 in the example's ``main()``."""
    import re

    stdout, wall = run_module("whisper_trtllm_tpu_torch.cli.gpu_check", 600)
    report = json.loads(stdout.strip().splitlines()[-1])
    checks = {k: v for k, v in report.items() if isinstance(v, dict)}
    for name, r in checks.items():
        print(f"gpu_check {name}: pass={r['pass']} "
              + " ".join(f"{k}={r[k]}" for k in r if k != "pass")
              + f" [{card}]")
    if not (report["pass"] is True and len(checks) == 13
            and all(r["pass"] is True for r in checks.values())):
        fail(f"gpu_check: not every check passed: {report}")
    print(f"gpu_check: all {len(checks)} checks passed in {wall:.1f} s of "
          f"wall time (process start included)")
    k7 = checks["cross_attn_kernel"]["launches"].get("cross_decode_mha", 0)

    stdout, wall = run_module(
        "whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel",
        300)
    line = stdout.strip().splitlines()[-1]
    print(f"example: {line} ({wall:.1f} s of wall time)")
    k8 = int(re.search(r"launches=(\d+)", line).group(1))
    return {"cross_decode_mha": k7}, {"fused_bias_gelu": k8}


# --------------------------------------------------------------------------
# phase 4: end to end
# --------------------------------------------------------------------------

# name: (weights, compute dtype, kv_cache_dtype, cross_kv_layout, held to
# the CPU tokens, timed by stage). "int8" is the artifact as committed;
# "float" the artifact dequantized in memory; "chain" the float tree through
# the session's load-time chain (int8 weights, int8 vocab table, fused q/k/v)
CONFIGS = {
    "A": ("int8", "float32", "auto", "auto", True, True),
    "B": ("int8", "bfloat16", "int8", "auto", False, True),
    "C": ("int8", "float32", "int8", "bhtd", True, False),
    "D": ("int8", "bfloat16", "fp8", "auto", False, False),
    "E": ("float", "float32", "auto", "auto", True, True),
    "F": ("float", "bfloat16", "auto", "auto", False, False),
    "G": ("chain", "bfloat16", "int8", "auto", False, False),
}


def float_tree(params):
    """The artifact's weights dequantized in memory with the port's
    ``dequantize_kernel``: kernel = kernel_q · scale, table = table_q ·
    scale[:, None], fp32. Quantizing it again gives the artifact back bit
    for bit; no float checkpoint exists on disk."""
    from whisper_trtllm_tpu_torch.quantization import dequantize_params

    return dequantize_params(params)


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, paths as "/encoder/layers/fc1/scale"."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def check_int8_equal(torch, got, want, tag):
    """Every int8 kernel and table of the artifact equals the session's,
    the fused q/k/v the concatenation of the three projections."""
    got, n = dict(leaves(got)), 0
    for path, ref in leaves(want):
        if not path.endswith(("kernel_q", "table_q")):
            continue
        if "/self_attn/" in path and path.split("/")[-2] in ("q", "k", "v"):
            continue
        n += 1
        if path not in got or not torch.equal(got[path], ref):
            fail(f"{tag}: {path} differs from the artifact's int8 values")
    for side in ("encoder", "decoder"):
        sa = want[side]["layers"]["self_attn"]
        ref = torch.cat([sa[k]["kernel_q"] for k in "qkv"], dim=-1)
        n += 1
        if not torch.equal(got[f"/{side}/layers/self_attn/qkv/kernel_q"], ref):
            fail(f"{tag}: the fused q/k/v int8 kernel of the {side} differs "
                 f"from the artifact's three")
    print(f"{tag}: {n} int8 tensors bit-equal to the artifact's")


def host_us(torch, fn, n, spin_cycles=0):
    """Host µs a call of ``fn`` over ``n`` calls, after one untimed call.
    With ``spin_cycles`` the calls queue behind a spin of the card far
    longer than their work, so a launch that returns at once only queues
    and the time is the host's; the second value says whether the spin
    was still running at the end (no call waited for the card)."""
    fn()
    torch.cuda.synchronize()
    spun = torch.cuda.Event()
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
    spun.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    queued = not spun.query()
    torch.cuda.synchronize()
    return us, queued


def step_host_costs(torch, session, enc, gen, tag, card):
    """The host time of one decode step, two ways, on the decode's own
    captured entry (the one just run) from a reset state: a replay of the
    captured step (what every step of the loop costs now), queued behind a
    spin of the card so that none waits for it; and the same step run
    eagerly (what it cost before the graph, its host reads apart), with no
    spin: its hundred-odd launches a step would fill the launch queue
    behind one and wait, and the card, idle most of an eager step, keeps
    up with them. At most ``max_len - 1`` steps a state. Returns the
    replay's µs."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt

    entry = next(reversed(gen_rt._GRAPHS.values()))
    s, cfg = entry.state, session.cfg
    n = s.tokens.shape[1] - 1
    fused = wmodel.decode_step_plan(session.params, cfg, s.self_kv,
                                    entry.cross_kv)

    def eager():
        gen_rt.greedy_step(session.params, cfg, gen, s, entry.cross_kv,
                           entry.rules, fused)

    out = {}
    with torch.inference_mode():
        for name, fn, spin in (("replay", entry.replay, SPIN_CYCLES),
                               ("eager", eager, 0)):
            # one untimed call (host_us's) and n timed ones: n + 1 steps
            # from pos 0 would pass the buffer's end, so n - 1 are timed
            gen_rt.reset_state(s, cfg, entry.rules)
            out[name] = host_us(torch, fn, n - 1, spin)
        gen_rt.reset_state(s, cfg, entry.rules)
    (rep, queued), (eag, _) = out["replay"], out["eager"]
    print(f"{tag} host per decode step [{card}]: replay {rep:.2f} us "
          f"(over {n - 1} replays behind a spin of the card, "
          f"{'all queued' if queued else 'a replay waited'}), the same "
          f"step eager {eag:.2f} us")
    return rep


def k6_gate_cost(torch, session, enc, gen, card):
    """What the fused-step gate costs now: ``decode_step_plan`` (it walks
    the weight tree) runs once a decode call, before the loop."""
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt

    params, cfg = session.params, session.cfg
    with torch.inference_mode():
        cross = gen_rt.build_cross_kv(params, cfg, enc, gen)
        self_kv = wmodel.init_self_kv(cfg, enc.shape[0], 33, dtype=enc.dtype,
                                      device=DEVICE)
    if not wmodel.decode_step_plan(params, cfg, self_kv, cross):
        fail("e2e E: the float tree does not take the fused step")
    gate, _ = host_us(torch, lambda: wmodel.decode_step_plan(
        params, cfg, self_kv, cross), 2000)
    print(f"e2e E host cost of K6's gate [{card}]: {gate:.2f} us once a "
          f"decode call (decode_step_plan); the K6 wrapper runs at the "
          f"warm-up step and the capture only, a replay calls no Python")


# the kernels a captured decode step launches, by the names the profiler
# traces (csrc/decode_attention.cu, layer_norm.cu, fused_decoder_step.cu)
# host seconds a trace keeps on each side of the traced call (traced_run)
TRACE_PAD_S = 1.0
# traces of one call that may come out short of kernel records before the
# last one is returned as it is (traced_run)
TRACE_ATTEMPTS = 5
# small kernels a trace launches before its pad: PRIME_LAUNCHES, and
# RETRACE_SHIFT more on each retrace of the same call
PRIME_LAUNCHES = 4
RETRACE_SHIFT = 256
KERNEL_SYMBOLS = {"decode_attn": ("decode_dh_minor", "decode_direct",
                                  "decode_t_minor"),
                  "layer_norm": ("layer_norm_kernel", "layer_norm_wide_kernel"),
                  "fused_decoder_layer_step": ("fused_step_kernel",)}


def traced_run(torch, fn, symbols=None):
    """``fn`` under ``torch.profiler``, counted from zero: (the card's busy
    ms, the kernel launches the trace holds of each wrapper in ``symbols``
    (default ``KERNEL_SYMBOLS``), the wrappers' own counts of them).

    The trace keeps the card's records that fall inside its window on the
    host's clock, the card's timestamps mapped onto it: ``TRACE_PAD_S`` of
    the host's time on both sides of ``fn`` keep its first and last
    launches away from the window's edges. CUPTI is torn down after each
    trace and attaches again at the next one's first CUDA calls: a few
    small kernels and a sync (some microseconds of the busy time) make
    those calls before the pad, so that ``fn``'s first launches are not.

    CUPTI has dropped a few kernel records from a trace of a replayed
    call whose next trace held them all. A trace that holds fewer records
    of some wrapper's kernel than the wrapper counted, and more of none,
    is printed and taken again, the decode loop's counts put back as they
    were before it, up to ``TRACE_ATTEMPTS`` traces. Within one process
    the same record went missing from every retrace of the same call (S2:
    571 of 572 K5 records, five times), so each retrace launches
    ``RETRACE_SHIFT`` more small kernels before its pad, which changes
    where the call's records fall among the trace's. The caller holds the
    returned trace to the counters exactly, so a count that is wrong on
    every call still fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.utils.profile_transcribe import _device_us

    symbols = symbols or KERNEL_SYMBOLS
    loop_before = dict(vars(gen_rt.LOOP))
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        vars(gen_rt.LOOP).update(loop_before)
        torch.cuda.synchronize()
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm = torch.zeros(1, device=DEVICE)
            for _ in range(PRIME_LAUNCHES + RETRACE_SHIFT * (attempt - 1)):
                warm.add_(1)
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        counted = {k: KERNELS[k].launches for k in symbols}
        traced = {k: 0 for k in symbols}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for k, names in symbols.items():
                    traced[k] += any(n in e.name for n in names)
        short = any(traced[k] < counted[k] for k in symbols)
        over = any(traced[k] > counted[k] for k in symbols)
        if not short or over or attempt == TRACE_ATTEMPTS:
            break
        print(f"traced_run: trace {attempt} of at most {TRACE_ATTEMPTS} "
              f"holds {traced} kernel records for the wrappers' {counted} "
              f"launches; tracing the call again")
    busy = sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")) / 1e3
    return busy, traced, counted


def timed(torch, fn, reps=5):
    """(fn's result, median ms, min ms, max ms) of ``reps`` calls, each
    between two syncs of the card (the bench's ``timed_calls``)."""
    from whisper_trtllm_tpu_torch.benchmarks.benchmark import timed_calls

    out, times = timed_calls(fn, torch.device(DEVICE), reps, warmup=0)
    return out, statistics.median(times), min(times), max(times)


def transcribe_launches(cfg, gen_tokens: int, batches: int, fused: bool,
                        frontend: bool) -> dict:
    """Kernel launches of ``batches`` transcribes of ``gen_tokens`` decode
    steps each: per batch K3 once with the frontend, K1 once an encoder
    layer and K5 twice an encoder layer and once after; per step, unfused,
    K2 twice a layer (self and cross attention) and K5 three times a layer
    and once after; fused (float weights and KV caches), K5 for each
    layer's LN1 and the final LN and one K6 a layer for the rest."""
    le, ld = cfg.encoder_layers, cfg.decoder_layers
    if fused:
        step = {"decode_attn": 0, "fused_decoder_layer_step": ld,
                "layer_norm": ld + 1}
    else:
        step = {"decode_attn": 2 * ld, "fused_decoder_layer_step": 0,
                "layer_norm": 3 * ld + 1}
    return {"flash_fwd": le * batches, "flash_bwd": 0,
            "decode_attn": step["decode_attn"] * gen_tokens * batches,
            "stft_log_mel": batches if frontend else 0,
            "layer_norm": (2 * le + 1 + step["layer_norm"] * gen_tokens)
            * batches,
            "fused_decoder_layer_step":
                step["fused_decoder_layer_step"] * gen_tokens * batches,
            "cross_decode_mha": 0}


def end_to_end(torch, np, card):
    """Returns each configuration's kernel launch counts."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    waves = [read_wav(os.path.join(EVAL_DIR, f"utt{i:02d}.wav"))
             for i in range(len(expected))]
    audio_s = sum(len(w) for w in waves) / 16000.0
    audio = np.stack([pad_or_trim(w) for w in waves])
    params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
    params_cpu, _ = load_checkpoint(ARTIFACT, device="cpu")
    trees = {"int8": (params, params_cpu),
             "float": (float_tree(params), float_tree(params_cpu))}
    trees["chain"] = trees["float"]

    counts = {}
    for name, (weights, compute, kv, layout, vs_cpu, timing) in CONFIGS.items():
        tag = (f"e2e {name} ({weights} weights, {compute}, kv {kv}, cross "
               f"{layout})")
        gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                               cross_kv_layout=layout)
        chain = weights == "chain"
        rt = RuntimeConfig(compute_dtype=compute,
                           weight_dtype="int8" if chain else "native",
                           quantize_vocab=chain, fuse_qkv=chain)
        tree, tree_cpu = trees[weights]
        session = WhisperSession(tree, cfg, gen, rt, device=DEVICE)
        if chain:
            check_int8_equal(torch, session.params, params, tag)

        # this path, counted: launches made from here to the read below;
        # the decode's steps are the loop's (its warm-up steps, then the
        # replays of the step it captured): up to FINISH_CHECK_EVERY - 1
        # past the last EOS
        reset_launch_counts()
        gen_rt.reset_loop_counts()
        tokens, lengths = session.transcribe(audio)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        loop = gen_rt.LOOP
        steps = loop.steps
        if not (loop.captures == 1 and loop.eager_steps == gen_rt.WARMUP_STEPS
                and 0 <= steps - (int(lengths.max()) - 1)
                < gen_rt.FINISH_CHECK_EVERY):
            fail(f"{tag}: the decode ran {loop.eager_steps} eager steps, "
                 f"{loop.replays} replays, {loop.captures} captures for "
                 f"lengths {lengths.tolist()}")

        texts = [ids_to_text(tokens[i, :lengths[i]])
                 for i in range(len(expected))]
        print(f"{tag}: tokens {tokens.shape} lengths {lengths.tolist()} "
              f"decode steps {steps} ({loop.eager_steps} warm-up, "
              f"{loop.replays} replays, {loop.host_reads} host reads; "
              f"capture {loop.capture_ms:.2f} ms) launches {launches}")
        for got, want in zip(texts, expected):
            print(f"{tag}: {'ok  ' if got == want else 'BAD '} {got!r}")
        if texts != expected:
            fail(f"{tag}: transcripts differ from artifacts/expected.json")
        if name == "E":
            float_tokens = tokens
        want = transcribe_launches(cfg, steps, 1, fused=weights == "float",
                                   frontend=True)
        if launches != want:
            fail(f"{tag}: kernel launches {launches}, expected {want}")
        counts[name] = launches

        if vs_cpu:
            tok_cpu, len_cpu = WhisperSession(
                tree_cpu, cfg, gen, rt, device="cpu").transcribe(audio)
            if not (np.array_equal(tok_cpu, tokens)
                    and np.array_equal(len_cpu, lengths)):
                fail(f"{tag}: card tokens differ from the plain path's "
                     f"tokens on the CPU")
            print(f"{tag}: tokens equal the plain path's on the CPU")
        if not timing:
            continue
        audio_t = torch.from_numpy(audio)
        with torch.inference_mode():
            mel, fe_ms, fe_lo, fe_hi = timed(
                torch, lambda: session.frontend(audio_t))
            enc, en_ms, en_lo, en_hi = timed(
                torch, lambda: session.encode(mel))
            gen_rt.reset_loop_counts()
            _, de_ms, de_lo, de_hi = timed(
                torch,
                lambda: gen_rt.greedy_decode(session.params, cfg, enc, gen))
            # every step of the timed decodes was a replay
            de_steps = gen_rt.LOOP.replays / 5
            if gen_rt.LOOP.eager_steps or gen_rt.LOOP.captures:
                fail(f"{tag}: a timed decode did not only replay")
        step_host_costs(torch, session, enc, gen, tag, card)
        if name == "E":
            k6_gate_cost(torch, session, enc, gen, card)
        torch.cuda.reset_peak_memory_stats()
        _, tr_ms, tr_lo, tr_hi = timed(torch,
                                       lambda: session.transcribe(audio))
        stats = session.memory_stats()
        print(f"{tag} timing (median of 5, min..max) batch 4, {de_steps:g} "
              f"decode steps [{card}]: frontend {fe_ms:.2f} ms ({fe_lo:.2f}..{fe_hi:.2f}), "
              f"encode {en_ms:.2f} ms ({en_lo:.2f}..{en_hi:.2f}), "
              f"decode {de_ms:.2f} ms ({de_lo:.2f}..{de_hi:.2f}), "
              f"transcribe {tr_ms:.2f} ms ({tr_lo:.2f}..{tr_hi:.2f}), "
              f"per decode step {de_ms / de_steps:.3f} ms")
        # the card's idle share over an untraced transcribe: one traced
        # transcribe's device time over the median of the five above; and
        # its launches of the captured step's kernels against the trace
        busy, traced, counted = traced_run(
            torch, lambda: session.transcribe(audio))
        if traced != counted:
            fail(f"{tag}: the counters {counted} differ from the profiler's "
                 f"launches {traced}")
        print(f"{tag} idle share [{card}]: device busy {busy:.2f} ms of a "
              f"traced transcribe, idle {1 - busy / tr_ms:.3f} of the "
              f"median untraced transcribe ({tr_ms:.2f} ms); the traced "
              f"launches {traced} equal the counters")
        print(f"{tag} throughput [{card}]: {audio_s / (tr_ms / 1e3):.2f} "
              f"audio-s/s of speech ({audio_s:.2f} s in 4 utterances), "
              f"{4 * 30.0 / (tr_ms / 1e3):.2f} audio-s/s of 30 s windows; "
              f"peak device memory over the transcribes "
              f"{stats['peak_bytes_in_use']} bytes (weights included)")
    del session
    check_quant_primitives(torch, card)
    counts.update(weight_modes(torch, np, card, cfg, trees["float"], audio,
                               expected, float_tokens))
    return counts


# name: (weights, compute dtype, kv_cache_dtype, cross_kv_layout), on the
# float tree: "int4" and "fp8" through the session's load-time chain,
# "smooth" rewritten by smooth_quantize_whisper on stats calibrated on the
# card; every decode step unfused (K6's gate refuses these projections)
MODE_CONFIGS = {
    "I32": ("int4", "float32", "auto", "bhtd"),
    "I16": ("int4", "bfloat16", "int8", "auto"),
    "J32": ("fp8", "float32", "auto", "bhtd"),
    "J16": ("fp8", "bfloat16", "int8", "auto"),
    "K32": ("smooth", "float32", "auto", "bhtd"),
    "K16": ("smooth", "bfloat16", "int8", "auto"),
}
# the calibration pass on the card against the CPU's on the same batch:
# each stat is an abs-max of fp32 activations whose sums run in another
# order (K1's products as 3xTF32), so it moves in the last bits only
STATS_RTOL = 1e-4
# SmoothQuant's integer product on the card: torch._int_mm takes more than
# 16 rows, so the decode step's 1 to 16 are padded; 6000 is the encoder's
INT_MM_ROWS = (1, 4, 16, 17, 6000)


def check_quant_primitives(torch, card):
    """What the weight modes run on the card that must equal the CPU bit
    for bit: SmoothQuant's int8 × int8 product (``int8_matmul``) at
    ``INT_MM_ROWS`` rows and tiny.en's two depths, a sum past 2^24 among
    them; the float8_e4m3fn cast over in-range values (±448, subnormals,
    round-to-even ties, every finite bf16 value up to 448, random values at
    four scales), the fp8 QDQ and SmoothQuant's per-token int8 of
    activations; the int4 unpack of every byte."""
    from whisper_trtllm_tpu_torch.ops.functional import (
        int8_matmul,
        smooth_quant_activation,
    )
    from whisper_trtllm_tpu_torch.quantization import (
        fp8_qdq_activation,
        unpack_int4_kernel,
    )

    g = torch.Generator().manual_seed(SEED)
    for k, n in ((384, 1536), (1536, 384)):
        for rows in INT_MM_ROWS:
            a = torch.randint(-127, 128, (rows, k), generator=g,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), generator=g,
                              dtype=torch.int8)
            a[0], b[:, 1] = 127, 127            # a sum of k · 127²
            want = int8_matmul(a, b)
            got = int8_matmul(a.to(DEVICE), b.to(DEVICE)).cpu()
            if not torch.equal(got, want):
                fail(f"int8 product: {rows} x {k} x {n} differs from the "
                     f"CPU's by {int((got - want).abs().max())}")
    print(f"int8 x int8 product (torch._int_mm, int32) [{card}]: equal to "
          f"the CPU's at rows {list(INT_MM_ROWS)}, K x N 384 x 1536 and "
          f"1536 x 384 (largest sum 1536 * 127^2 = {1536 * 127 ** 2})")

    sub = 2.0 ** -9                             # e4m3's least subnormal
    edges = torch.tensor([448.0, -448.0, 0.0, -0.0, sub, -sub, 0.5 * sub,
                          1.5 * sub, 2.5 * sub, 2.0 ** -6, 1.0625, 1.1875,
                          232.0, 240.0, 416.0, 440.0, 447.99])
    every_bf16 = torch.arange(0, 1 << 16, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    x = torch.cat([edges, every_bf16] + [torch.randn(1 << 20, generator=g) * s
                                         for s in (1.0, 30.0, 1e-2, 1e-3)])
    x = x[x.abs() <= 448]
    want = x.to(torch.float8_e4m3fn).view(torch.uint8)
    got = x.to(DEVICE).to(torch.float8_e4m3fn).view(torch.uint8).cpu()
    if not torch.equal(got, want):
        fail(f"fp8 cast: {int((got != want).sum())} of {x.numel()} values "
             f"differ from the CPU's")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((4, 1, 384), (4, 1500, 384), (4, 1, 1536)):
            act = (torch.randn(shape, generator=g) * 3).to(dtype)
            if not torch.equal(fp8_qdq_activation(act.to(DEVICE)).cpu(),
                               fp8_qdq_activation(act)):
                fail(f"fp8 QDQ of a {dtype} {shape} activation differs "
                     f"from the CPU's")
            smooth = torch.rand(shape[-1], generator=g) + 0.5
            got = smooth_quant_activation(act.to(DEVICE), smooth.to(DEVICE))
            want = smooth_quant_activation(act, smooth)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
                fail(f"SmoothQuant's int8 of a {dtype} {shape} activation "
                     f"differs from the CPU's")
        packed = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
        if not torch.equal(unpack_int4_kernel(packed.to(DEVICE), dtype).cpu(),
                           unpack_int4_kernel(packed, dtype)):
            fail(f"int4 unpack to {dtype} differs from the CPU's")
    print(f"fp8 cast [{card}]: {x.numel()} values in [-448, 448] bit-equal "
          f"to the CPU's; fp8 QDQ and SmoothQuant's int8 of fp32 and bf16 "
          f"activations and the int4 unpack of every byte equal too")


def check_quantized_equal(torch, got, want, tag):
    """Every leaf of ``want``'s quantized projections (the port's quantizer
    run on the CPU: the one-byte kernel, its scales, SmoothQuant's smooth)
    equals the session's bit for bit, after the session's cast of the
    float leaves to its compute dtype."""
    got, n = dict(leaves(got)), 0
    for path, ref in leaves(want):
        parent = path.rsplit("/", 1)[0]
        if not any(f"{parent}/{k}" in got for k in ("kernel_q4", "kernel_f8",
                                                    "kernel_sq")):
            continue
        if path.endswith("/bias"):
            continue
        ref, g = torch.as_tensor(ref), torch.as_tensor(got[path]).cpu()
        if ref.dtype.is_floating_point and ref.element_size() > 1:
            ref = ref.to(g.dtype)
        if g.dtype == torch.float8_e4m3fn:
            g, ref = g.view(torch.uint8), ref.view(torch.uint8)
        n += 1
        if g.dtype != ref.dtype or not torch.equal(g, ref):
            fail(f"{tag}: {path} differs from the CPU quantizer's")
    if not n:
        fail(f"{tag}: the session holds no quantized projection")
    print(f"{tag}: {n} quantized tensors bit-equal to the port's quantizer "
          f"run on the CPU")


def weight_modes(torch, np, card, cfg, float_trees, audio, expected,
                 float_tokens):
    """Configurations I (int4), J (fp8 QDQ) and K (SmoothQuant) on the
    float tree, fp32 and bf16: the four texts, the quantized tensors
    against the CPU quantizer's, launches exact with no K6 over one
    warm-up step, one capture and replays; I32's tokens equal the CPU's,
    J32's and K32's (their activations round to fp8 or int8 from values
    that differ from the CPU's in the last bits) as a share, with the
    first step's largest logit gap; transcribe and decode ms. Returns
    each configuration's launch counts."""
    from whisper_trtllm_tpu_torch.audio import LogMelSpectrogram
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.quantization import (
        fp8_quantize,
        smooth_quantize_whisper,
        weight_only_quantize_int4,
        whisper_act_stats,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    float_card, float_cpu = float_trees
    # SmoothQuant's calibration batch: the four mels (the card's frontend,
    # fp32) and the first 16 tokens of E's greedy decode, on both devices
    with torch.inference_mode():
        mel = LogMelSpectrogram(cfg.num_mel_bins, device=DEVICE)(audio)
    calib = float_tokens[:, :16]
    t0 = time.perf_counter()
    stats = whisper_act_stats(float_card, cfg, mel, calib)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    stats_cpu = whisper_act_stats(float_cpu, cfg, mel.cpu(), calib)
    gap, where = 0.0, ""
    for side in stats_cpu:
        for k, ref in stats_cpu[side].items():
            rel = np.abs(stats[side][k] - ref) / np.maximum(
                np.abs(ref), np.finfo(np.float32).tiny)
            if float(rel.max()) >= gap:
                gap, where = float(rel.max()), f"{side}/{k}"
    print(f"SmoothQuant calibration on the card ({card_s:.2f} s) [{card}]: "
          f"largest relative gap to the CPU's stats {gap:.3e} ({where}), "
          f"limit {STATS_RTOL}")
    if not gap <= STATS_RTOL:
        fail(f"SmoothQuant calibration: the card's stats are {gap:.3e} "
             f"relative from the CPU's at {where}")
    sq = smooth_quantize_whisper(float_card, stats)
    sq_cpu = smooth_quantize_whisper(float_cpu, stats_cpu)
    check_quantized_equal(torch, sq_cpu, smooth_quantize_whisper(
        float_card, stats_cpu), "SmoothQuant rewrite of the CPU's stats")
    trees = {"int4": (float_card, weight_only_quantize_int4(float_cpu)),
             "fp8": (float_card, fp8_quantize(float_cpu)),
             "smooth": (sq, smooth_quantize_whisper(float_cpu, stats))}

    counts = {}
    audio_t = torch.from_numpy(audio)
    for name, (mode, compute, kv, layout) in MODE_CONFIGS.items():
        tag = (f"e2e {name} ({mode} weights, {compute}, kv {kv}, cross "
               f"{layout})")
        gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                               cross_kv_layout=layout)
        rt = RuntimeConfig(compute_dtype=compute,
                           weight_dtype="native" if mode == "smooth" else mode)
        tree, quantized_cpu = trees[mode]
        session = WhisperSession(tree, cfg, gen, rt, device=DEVICE)
        check_quantized_equal(torch, session.params, quantized_cpu, tag)

        reset_launch_counts()
        gen_rt.reset_loop_counts()
        tokens, lengths = session.transcribe(audio)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        loop = gen_rt.LOOP
        steps = loop.steps
        if not (loop.captures == 1 and loop.eager_steps == gen_rt.WARMUP_STEPS
                and 0 <= steps - (int(lengths.max()) - 1)
                < gen_rt.FINISH_CHECK_EVERY):
            fail(f"{tag}: the decode ran {loop.eager_steps} eager steps, "
                 f"{loop.replays} replays, {loop.captures} captures for "
                 f"lengths {lengths.tolist()}")
        texts = [ids_to_text(tokens[i, :lengths[i]])
                 for i in range(len(expected))]
        print(f"{tag}: lengths {lengths.tolist()} decode steps {steps} "
              f"({loop.eager_steps} warm-up, {loop.replays} replays; capture "
              f"{loop.capture_ms:.2f} ms) launches {launches}")
        for got, want in zip(texts, expected):
            print(f"{tag}: {'ok  ' if got == want else 'BAD '} {got!r}")
        if texts != expected:
            fail(f"{tag}: transcripts differ from artifacts/expected.json")
        want = transcribe_launches(cfg, steps, 1, fused=False, frontend=True)
        if launches != want:
            fail(f"{tag}: kernel launches {launches}, expected {want}")
        counts[name] = launches

        if compute == "float32":
            cpu = WhisperSession(tree, cfg, gen, rt, device="cpu")
            tok_cpu, len_cpu = cpu.transcribe(audio)
            if mode == "int4":
                if not (np.array_equal(tok_cpu, tokens)
                        and np.array_equal(len_cpu, lengths)):
                    fail(f"{tag}: card tokens differ from the plain path's "
                         f"tokens on the CPU")
                print(f"{tag}: tokens equal the plain path's on the CPU")
            else:
                mask = np.arange(tokens.shape[1])[None] < np.maximum(
                    lengths, len_cpu)[:, None]
                share = float((tokens == tok_cpu)[mask].mean())
                start = torch.full((len(expected), 1),
                                   cfg.decoder_start_token_id)
                with torch.inference_mode():
                    logits = [wmodel.decode_full(
                        s.params, cfg, start.to(s.device),
                        s.encode(s.frontend(audio)))[:, -1].float().cpu()
                        for s in (session, cpu)]
                print(f"{tag}: {share:.4f} of the tokens equal the CPU's "
                      f"(lengths {len_cpu.tolist()} there); the first "
                      f"step's largest logit gap to the CPU's "
                      f"{float((logits[0] - logits[1]).abs().max()):.3e} "
                      f"(gated on the texts, not on equality)")
            del cpu

        with torch.inference_mode():
            enc = session.encode(session.frontend(audio_t))
        _, tr_ms, tr_lo, tr_hi = timed(torch,
                                       lambda: session.transcribe(audio))
        gen_rt.reset_loop_counts()
        with torch.inference_mode():
            _, de_ms, de_lo, de_hi = timed(
                torch,
                lambda: gen_rt.greedy_decode(session.params, cfg, enc, gen))
        de_steps = gen_rt.LOOP.replays / 5
        if gen_rt.LOOP.eager_steps or gen_rt.LOOP.captures:
            fail(f"{tag}: a timed decode did not only replay")
        print(f"{tag} timing (median of 5, min..max) batch 4 [{card}]: "
              f"transcribe {tr_ms:.2f} ms ({tr_lo:.2f}..{tr_hi:.2f}), "
              f"decode {de_ms:.2f} ms ({de_lo:.2f}..{de_hi:.2f}) over "
              f"{de_steps:g} steps, per decode step {de_ms / de_steps:.4f} ms")
        del session, enc
    return counts


# the sampled decode against the CPU's: the same counter-based draw on both,
# but the card's logits and Gumbel noise differ from the CPU's in the last
# bits, so a near tie may break the other way and the rest of that lane
# follow it; at least this share of the generated tokens must agree
SAMPLED_AGREEMENT = 0.6
SAMPLED = dict(temperature=2.0, top_k=40, top_p=0.95, seed=1)


def decode_features(torch, np, card):
    """The JAX loop's processors through the captured step on the trained
    artifact, in E (fp32, float tree; each greedy variant token-equal to
    the CPU's) and B (the serving precision): timestamps (the tiny.en
    <|notimestamps|> id 50362 set in an in-memory copy of the config), a
    prompted decode (previous-text conditioning, and the plain prefix as a
    prompt, which must give the plain decode), bad and stop words taken
    from the plain decode, min-new-tokens, and a sampled decode (the same
    seed twice: the same tokens; against the CPU: ``SAMPLED_AGREEMENT``)."""
    import dataclasses

    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        EVAL_DIR, f"utt{i:02d}.wav"))) for i in range(4)])
    params, cfg = load_checkpoint(ARTIFACT, device="cpu")
    cfg = dataclasses.replace(cfg, no_timestamps_token_id=50362)
    ts_begin = cfg.no_timestamps_token_id + 1
    sot, notime = cfg.decoder_start_token_id, cfg.no_timestamps_token_id
    for name, tree, compute, kv, vs_cpu in (
            ("E", float_tree(params), "float32", "auto", True),
            ("B", params, "bfloat16", "int8", False)):
        tag = f"decode features {name}"
        rt = RuntimeConfig(compute_dtype=compute)
        devs = (DEVICE, "cpu") if vs_cpu else (DEVICE,)
        sessions = {d: WhisperSession(tree, cfg, runtime=rt, device=d)
                    for d in devs}
        with torch.inference_mode():
            enc = {d: ss.encode(ss.frontend(audio))
                   for d, ss in sessions.items()}

        def run(dev, prompt=None, **kw):
            ss = sessions[dev]
            gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv, **kw)
            if prompt is None:
                out = gen_rt.greedy_decode(ss.params, cfg, enc[dev], gen)
            else:
                out = gen_rt.greedy_decode_prompted(ss.params, cfg, enc[dev],
                                                    prompt, gen)
            return tuple(x.cpu().numpy() for x in out)

        base, base_lens = run(DEVICE)
        prev = [int(t) for t in base[3, 2:base_lens[3] - 1]]
        prompt = np.asarray([[50360] + prev + [sot, notime]] * 4, np.int32)
        variants = {
            "timestamps": dict(return_timestamps=True),
            "prompted": dict(prompt=prompt),
            "bad words": dict(bad_words=((int(base[0, 2]),),
                                         (int(base[1, 2]), int(base[1, 3])))),
            "stop words": dict(stop_words=((int(base[2, 3]),
                                            int(base[2, 4])),)),
            "min new tokens": dict(min_new_tokens=int(base_lens.max())),
        }
        results = {}
        for what, kw in variants.items():
            toks, lens = run(DEVICE, **kw)
            results[what] = (toks, lens)
            if vs_cpu:
                ctoks, clens = run("cpu", **kw)
                if not (np.array_equal(toks, ctoks)
                        and np.array_equal(lens, clens)):
                    fail(f"{tag} {what}: card tokens differ from the CPU's")
            print(f"{tag} {what}: lengths {lens.tolist()}, lane 0 "
                  f"{toks[0, :lens[0]].tolist()}"
                  + (", tokens equal the CPU's" if vs_cpu else ""))
        # what each rule must show whatever the precision
        toks, lens = results["timestamps"]
        if not (ts_begin <= toks[:, 1]).all() or (toks == notime).any() or \
                (toks[:, 1] > ts_begin + cfg.max_initial_timestamp_index).any():
            fail(f"{tag} timestamps: the first token is no timestamp within "
                 f"the initial bound, or <|notimestamps|> appears")
        toks, lens = results["bad words"]
        if (toks[:, 2:] == base[0, 2]).any():
            fail(f"{tag} bad words: the banned token was generated")
        toks, lens = results["stop words"]
        if lens[2] > 5:
            fail(f"{tag} stop words: lane 2 ran on past its stop word")
        toks, lens = results["min new tokens"]
        if (lens < 2 + int(base_lens.max()) + 1).any():
            fail(f"{tag} min new tokens: a lane ended before "
                 f"{int(base_lens.max())} new tokens")
        toks, lens = results["prompted"]
        if not np.array_equal(toks[:, :prompt.shape[1]], prompt):
            fail(f"{tag} prompted: the prompt is not the buffer's head")
        # the plain prefix as a prompt, one token shorter a budget: the
        # plain decode's buffer
        gen_p = GenerationConfig(max_new_tokens=31, kv_cache_dtype=kv)
        ptoks, plens = (x.cpu().numpy() for x in gen_rt.greedy_decode_prompted(
            sessions[DEVICE].params, cfg, enc[DEVICE],
            np.asarray([[sot, notime]] * 4, np.int32), gen_p))
        if not (np.array_equal(ptoks, base) and np.array_equal(plens,
                                                               base_lens)):
            fail(f"{tag} prompted: the plain prefix as a prompt does not "
                 f"give the plain decode")
        # sampled: one draw a seed; against the CPU's, a stated share
        a, alens = run(DEVICE, **SAMPLED)
        b, blens = run(DEVICE, **SAMPLED)
        other, _ = run(DEVICE, **{**SAMPLED, "seed": 2})
        if not (np.array_equal(a, b) and np.array_equal(alens, blens)):
            fail(f"{tag} sampled: the same seed gave other tokens")
        line = (f"{tag} sampled {SAMPLED}: lengths {alens.tolist()}, the "
                f"same seed twice equal, seed 2 "
                f"{'differs' if not np.array_equal(a, other) else 'equal'}")
        if vs_cpu:
            c, _ = run("cpu", **SAMPLED)
            agree = float((a[:, 2:] == c[:, 2:]).mean())
            if agree < SAMPLED_AGREEMENT:
                fail(f"{tag} sampled: {agree:.3f} of the tokens agree with "
                     f"the CPU's, below {SAMPLED_AGREEMENT}")
            line += f", {agree:.3f} of the generated tokens equal the CPU's"
        print(line)
        del sessions, enc


# beams a lane in the beam phase: at the bundled batch of 4, B·K = 16
# lanes, the fused step's limit (K6's MAX_B) in E
BEAM_K = 4
# the card's beam scores against the CPU's, both fp32: the card's
# log-probabilities differ in the last bits (sums reordered), summed over
# up to 32 steps, then divided by the length
BEAM_SCORE_TOLERANCE = 1e-3
# tiny.en's <|startofprev|>: two below <|notimestamps|> (50362, the
# artifact's forced id) in the .en vocabulary, which has no word there
PREV_SOT = 50360
# where each bundled utterance starts in the long-form stream (s): two in
# the first 30 s window, two in the second
LONGFORM_OFFSETS_S = (0.0, 10.0, 30.0, 40.0)


def _beam_match(np, card_out, cpu_out, tag):
    """Every hypothesis token-equal, lengths equal, the scores at NEG_INF
    scale exactly and the others within ``BEAM_SCORE_TOLERANCE``; returns
    the largest score difference."""
    (t, s, l), (ct, cs, cl) = card_out, cpu_out
    if not (np.array_equal(t, ct) and np.array_equal(l, cl)):
        fail(f"{tag}: card hypotheses differ from the CPU's (lengths "
             f"{l.tolist()} vs {cl.tolist()})")
    big = np.abs(cs) >= 1e8
    err = float(np.abs(s[~big] - cs[~big]).max()) if (~big).any() else 0.0
    if not (np.array_equal(s[big], cs[big]) and err <= BEAM_SCORE_TOLERANCE):
        fail(f"{tag}: scores {s.tolist()} vs the CPU's {cs.tolist()}")
    return err


def beams_and_longform(torch, np, card):
    """Beam search (K = ``BEAM_K`` at batch 4) through the session on the
    trained artifact, in E (fp32, float tree: B·K = 16 lanes, K6) and B
    (bf16, int8 KV, T-minor: K2): the best hypotheses give the expected
    texts (the port's CPU beam output, equal to JAX's, gives them too);
    launch counts exact from the loop's steps, the first decode one
    warm-up step and one capture, a repeat decode replays only and its
    counters equal the profiler's; in E every hypothesis token-equal to the
    CPU's, scores within ``BEAM_SCORE_TOLERANCE``, and
    ``beam_decode_prompted`` too. Then ``transcribe_long_conditioned`` in E
    over the four utterances in one stream of more than 30 s, greedy and
    K = 2, per-chunk ids equal to the CPU's. Returns B's and E's launch
    counts of the first beam transcribe."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import beam, longform
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    waves = [read_wav(os.path.join(EVAL_DIR, f"utt{i:02d}.wav"))
             for i in range(len(expected))]
    audio = np.stack([pad_or_trim(w) for w in waves])
    params, cfg = load_checkpoint(ARTIFACT, device="cpu")
    specials = {cfg.eos_token_id, cfg.pad_token_id,
                cfg.decoder_start_token_id,
                *[t for _, t in cfg.forced_decoder_ids]}
    if not (PREV_SOT < cfg.vocab_size and PREV_SOT not in specials
            and ids_to_text([PREV_SOT]) == ""
            and (1, PREV_SOT + 2) in cfg.forced_decoder_ids):
        fail(f"beams: {PREV_SOT} is not <|startofprev|> in the artifact's "
             f"vocabulary")
    sot, notime = cfg.decoder_start_token_id, PREV_SOT + 2
    counts = {}
    for name, tree, compute, kv, vs_cpu in (
            ("E", float_tree(params), "float32", "auto", True),
            ("B", params, "bfloat16", "int8", False)):
        tag = f"beams {name} (K {BEAM_K}, batch 4, {compute}, kv {kv})"
        gen = GenerationConfig(max_new_tokens=32, num_beams=BEAM_K,
                               kv_cache_dtype=kv)
        rt = RuntimeConfig(compute_dtype=compute)
        session = WhisperSession(tree, cfg, gen, rt, device=DEVICE)
        max_len = 33

        # the beam path, counted from zero: one transcribe
        reset_launch_counts()
        gen_rt.reset_loop_counts()
        tokens, lengths = session.transcribe(audio)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        loop = gen_rt.LOOP
        steps = loop.steps
        pos = int(next(reversed(gen_rt._GRAPHS.values())).state.pos)
        # the loop stops at the first host read after go fell (when pos
        # stopped moving), or after max_len - 1 steps
        if not (loop.captures == 1 and loop.eager_steps == gen_rt.WARMUP_STEPS
                and (0 <= steps - pos < gen_rt.FINISH_CHECK_EVERY
                     or steps == max_len - 1)):
            fail(f"{tag}: the decode ran {loop.eager_steps} eager steps, "
                 f"{loop.replays} replays, {loop.captures} captures, pos "
                 f"{pos}")
        texts = [ids_to_text(tokens[i, :lengths[i]])
                 for i in range(len(expected))]
        print(f"{tag}: best lengths {lengths.tolist()}, decode steps {steps} "
              f"({loop.eager_steps} warm-up, {loop.replays} replays, "
              f"{loop.host_reads} host reads; the last step that moved pos: "
              f"{pos}; capture {loop.capture_ms:.2f} ms) launches {launches}")
        for got, want in zip(texts, expected):
            print(f"{tag}: {'ok  ' if got == want else 'BAD '} {got!r}")
        if texts != expected:
            fail(f"{tag}: the best hypotheses' transcripts differ from "
                 f"artifacts/expected.json")
        want = transcribe_launches(cfg, steps, 1, fused=name == "E",
                                   frontend=True)
        if launches != want:
            fail(f"{tag}: kernel launches {launches}, expected {want}")
        counts[name] = launches

        # a repeat decode replays only; its counters against the profiler
        gen_rt.reset_loop_counts()
        busy, traced, counted = traced_run(
            torch, lambda: session.transcribe(audio))
        if gen_rt.LOOP.eager_steps or gen_rt.LOOP.captures:
            fail(f"{tag}: a repeat decode did not only replay")
        want = transcribe_launches(cfg, gen_rt.LOOP.steps, 1,
                                   fused=name == "E", frontend=True)
        if traced != counted or any(counted[k] != want[k] for k in counted):
            fail(f"{tag}: the counters {counted} differ from the "
                 f"profiler's launches {traced} or from {want}")
        print(f"{tag}: a repeat transcribe replayed {gen_rt.LOOP.replays} "
              f"steps; the traced launches {traced} equal the counters "
              f"[{card}]")
        with torch.inference_mode():
            enc = session.encode(session.frontend(audio))
        gen_rt.reset_loop_counts()
        _, de, de_lo, de_hi = timed(torch, lambda: beam.beam_decode(
            session.params, cfg, enc, gen), 3)
        de_steps = gen_rt.LOOP.replays / 3
        print(f"{tag} beam decode (median of 3, min..max) [{card}]: "
              f"{de:.2f} ms ({de_lo:.2f}..{de_hi:.2f}), {de_steps:g} steps "
              f"at {4 * BEAM_K} lanes, {de / de_steps:.4f} ms a step")
        if not vs_cpu:
            del session, enc
            continue

        # every hypothesis against the CPU's, plain and prompted
        cpu = WhisperSession(tree, cfg, gen, rt, device="cpu")
        with torch.inference_mode():
            enc_cpu = cpu.encode(cpu.frontend(audio))

        def both(fn, *args):
            return [tuple(x.cpu().numpy() for x in fn(ss.params, cfg, e,
                                                     *args, gen))
                    for ss, e in ((session, enc), (cpu, enc_cpu))]

        card_out, cpu_out = both(beam.beam_decode)
        err = _beam_match(np, card_out, cpu_out, tag)
        if not np.array_equal(card_out[0][:, 0], tokens):
            fail(f"{tag}: beam_decode's best differs from the session's")
        best = card_out[0][3, 0]
        prev = [int(t) for t in best[2:card_out[2][3, 0] - 1]]
        prompt = np.asarray([[PREV_SOT] + prev + [sot, notime]] * 4,
                            np.int32)
        p_card, p_cpu = both(beam.beam_decode_prompted, prompt)
        p_err = _beam_match(np, p_card, p_cpu, f"{tag} prompted")
        if not (p_card[0][:, :, :prompt.shape[1]]
                == prompt[:, None]).all():
            fail(f"{tag} prompted: the prompt is not every beam's head")
        print(f"{tag}: all {BEAM_K} hypotheses of each utterance equal the "
              f"CPU's, scores within {err:.2e} (limit "
              f"{BEAM_SCORE_TOLERANCE}); beam_decode_prompted (prompt of "
              f"{prompt.shape[1]}) lengths {p_card[2][:, 0].tolist()} equal "
              f"the CPU's, scores within {p_err:.2e}")
        del session, cpu, enc, enc_cpu

    # long-form, conditioned, in E: the four utterances in one stream
    rate = 16000
    offsets = [int(o * rate) for o in LONGFORM_OFFSETS_S]
    stream = np.zeros(offsets[-1] + len(waves[-1]), np.float32)
    for o, w in zip(offsets, waves):
        stream[o:o + len(w)] = w
    tree = float_tree(params)
    for k in (1, 2):
        tag = f"long-form E (conditioned, num_beams {k})"
        gen = GenerationConfig(max_new_tokens=32, num_beams=k)
        outs = {}
        for dev in (DEVICE, "cpu"):
            session = WhisperSession(tree, cfg, gen, device=dev)
            outs[dev] = longform.transcribe_long_conditioned(
                session, stream, PREV_SOT, prev_context_tokens=4)
            del session
        (ids, n), (cpu_ids, cpu_n) = outs[DEVICE], outs["cpu"]
        if n != cpu_n or n < 2 or any(
                not np.array_equal(a, b) for a, b in zip(ids, cpu_ids)):
            fail(f"{tag}: the card's chunks {ids} differ from the CPU's "
                 f"{cpu_ids}")
        print(f"{tag}: {len(stream) / rate:.1f} s in {n} chunks, ids equal "
              f"the CPU's: " + " | ".join(ids_to_text(x) for x in ids))
    torch.cuda.synchronize()
    return counts


# --------------------------------------------------------------------------
# phase 4b: speculative decoding
# --------------------------------------------------------------------------

SPEC_GAMMAS = (2, 4)
# the artifact as its own draft, as the JAX package gives them on the CPU:
# (utterance, gamma) -> (rounds, accepted, length). Every proposal is
# accepted but on utt01 at gamma 2 and utt02: after a round that accepts
# all, the draft's cache keeps a row it never wrote (the JAX loop's), and
# a later proposal parts from the target's choice
SPEC_SELF = {(0, 2): (3, 6, 11), (0, 4): (2, 8, 11),
             (1, 2): (4, 6, 11), (1, 4): (2, 8, 11),
             (2, 2): (6, 10, 18), (2, 4): (4, 12, 18),
             (3, 2): (6, 12, 18), (3, 4): (4, 16, 18)}


def spec_launches(cfg, rounds: int, gamma: int, fused: bool) -> dict:
    """Kernel launches of one speculative utterance at batch 1 (target and
    draft of ``cfg``'s shape): K3 once, K1 once an encoder layer of each
    model, K5 twice an encoder layer + 1 for each encoder and 3 a layer + 1
    for each chunk (the two prefills and one target chunk a round; the
    chunk's attention is the plain formula); per round ``gamma`` draft
    steps, fused (K6 1, K5 1 a layer + 1) or unfused (K2 2, K5 3 a layer
    + 1)."""
    le, ld = cfg.encoder_layers, cfg.decoder_layers
    chunk = 3 * ld + 1
    steps = gamma * rounds
    return {"flash_fwd": 2 * le, "flash_bwd": 0,
            "decode_attn": 0 if fused else 2 * ld * steps,
            "stft_log_mel": 1,
            "layer_norm": 2 * (2 * le + 1) + 2 * chunk + chunk * rounds
            + (ld + 1 if fused else 3 * ld + 1) * steps,
            "fused_decoder_layer_step": ld * steps if fused else 0,
            "cross_decode_mha": 0}


def speculative(torch, np, card):
    """Speculative decoding (``runtime/speculative.py``) on the artifact,
    each bundled utterance at batch 1 from its audio through K3. S1: the
    int8 artifact (fp32, float caches) as its own draft, gamma 2 and 4:
    the 4 texts, tokens and lengths equal to the card's greedy transcribe
    of the same mel, tokens, length, rounds and accepted equal to the
    port's CPU run, the stats the JAX package's (``SPEC_SELF``), launches
    exact; a repeat of the first call replays only. S2: the float tree as
    target and ``init_params(cfg, seed=1)`` as draft (its steps K6), gamma
    4: the 4 texts, tokens and stats equal to the CPU's, 0 accepted,
    launches exact from the stats and equal to the profiler's over a traced
    call. S3 (ungated): batch-1 ms an utterance, speculative against
    greedy, and ``benchmarks/spec_loop_cost.py --preset tiny.en``'s ms a
    round. Returns S1's (gamma 4, utt00) and S2's (utt00) launches."""
    from whisper_trtllm_tpu_torch.audio import (
        LogMelSpectrogram,
        pad_or_trim,
        read_wav,
    )
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.models.whisper import init_params
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.speculative import (
        speculative_transcribe_tokens,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    audio = [pad_or_trim(read_wav(os.path.join(EVAL_DIR, f"utt{i:02d}.wav")))
             for i in range(len(expected))]
    params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
    params_cpu, _ = load_checkpoint(ARTIFACT, device="cpu")
    frontend = LogMelSpectrogram(cfg.num_mel_bins, device=DEVICE)
    gen = GenerationConfig(max_new_tokens=32)

    def run(t, d, mel, gamma, device=DEVICE):
        out = speculative_transcribe_tokens(t, cfg, d, cfg, mel, gen,
                                            gamma=gamma, with_stats=True,
                                            device=device)
        return [x.cpu().numpy() for x in out]

    def counted(t, d, i, gamma):
        """One call from utterance i's audio (K3, then the rounds),
        counted from zero: (its outputs, its mel, its launches)."""
        reset_launch_counts()
        gen_rt.reset_loop_counts()
        mel = frontend(audio[i][None])
        out = run(t, d, mel, gamma)
        torch.cuda.synchronize()
        return out, mel, {k: f.launches for k, f in KERNELS.items()}

    def check(tag, i, gamma, out, cpu, launches, fused):
        toks, length, rounds, accepted = out
        text = ids_to_text(toks[0, :length])
        if text != expected[i]:
            fail(f"{tag} utt{i:02d}: {text!r} is not {expected[i]!r}")
        if not all(np.array_equal(a, b) for a, b in zip(out, cpu)):
            fail(f"{tag} utt{i:02d}: the card's tokens, length {length}, "
                 f"rounds {rounds} or accepted {accepted} differ from the "
                 f"CPU's ({cpu[1]}, {cpu[2]}, {cpu[3]})")
        want = spec_launches(cfg, int(rounds), gamma, fused)
        if launches != want:
            fail(f"{tag} utt{i:02d}: kernel launches {launches}, expected "
                 f"{want}")

    counts = {}
    mels = [frontend(a[None]) for a in audio]
    s1_ms = {}
    for gamma in SPEC_GAMMAS:
        tag = f"spec S1 (int8 artifact as its own draft, gamma {gamma})"
        stats = []
        for i in range(len(audio)):
            out, mel, launches = counted(params, params, i, gamma)
            if i == 0 and not (gen_rt.LOOP.captures == 1
                               and gen_rt.LOOP.eager_steps
                               == gen_rt.WARMUP_STEPS):
                fail(f"{tag}: the first call ran {gen_rt.LOOP.captures} "
                     f"captures, {gen_rt.LOOP.eager_steps} eager rounds")
            if gen_rt.LOOP.steps != int(out[2]):
                fail(f"{tag} utt{i:02d}: {gen_rt.LOOP.steps} rounds ran, "
                     f"{int(out[2])} counted")
            cpu = run(params_cpu, params_cpu, mel.cpu(), gamma, "cpu")
            check(tag, i, gamma, out, cpu, launches, False)
            g_toks, g_lens = gen_rt.transcribe_tokens(params, cfg, mel, gen,
                                                      device=DEVICE)
            length, rounds, accepted = (int(x) for x in out[1:])
            if not (length == int(g_lens[0]) and np.array_equal(
                    out[0][0, :length], g_toks[0, :length].cpu().numpy())):
                fail(f"{tag} utt{i:02d}: tokens differ from the card's "
                     f"greedy transcribe (length {int(g_lens[0])})")
            if (rounds, accepted, length) != SPEC_SELF[(i, gamma)]:
                fail(f"{tag} utt{i:02d}: rounds {rounds}, accepted "
                     f"{accepted}, length {length}; the JAX package gives "
                     f"{SPEC_SELF[(i, gamma)]}")
            stats.append((length, rounds, accepted))
            if i == 0 and gamma == 4:
                counts["S1"] = launches
        print(f"{tag}: 4/4 texts, (length, rounds, accepted) {stats}, equal "
              f"to the CPU's and the JAX package's, tokens equal to the "
              f"card's greedy; launches exact")
        if gamma == SPEC_GAMMAS[0]:
            # S3: a repeat of the first call replays only
            gen_rt.reset_loop_counts()
            again = run(params, params, mels[0], gamma)
            loop = gen_rt.LOOP
            if loop.captures or loop.eager_steps or \
                    loop.replays != int(again[2]):
                fail(f"spec S3: a repeat ran {loop.captures} captures, "
                     f"{loop.eager_steps} eager rounds, {loop.replays} "
                     f"replays for {int(again[2])} rounds")
            print(f"spec S3: a repeat of S1's first call replayed "
                  f"{loop.replays} rounds, no capture")
        # S3: batch-1 ms an utterance, speculative against greedy, from mels
        spec_ms = [timed(torch, lambda: run(params, params, m, gamma), 3)[1]
                   for m in mels]
        s1_ms[gamma] = statistics.median(spec_ms)
    greedy_ms = [timed(torch, lambda: gen_rt.transcribe_tokens(
        params, cfg, m, gen, device=DEVICE)[0].cpu(), 3)[1] for m in mels]
    g_ms = statistics.median(greedy_ms)
    print(f"spec S3 batch 1, int8 artifact fp32, median over the 4 "
          f"utterances of the median of 3 [{card}]: greedy {g_ms:.3f} ms; "
          + ", ".join(f"gamma {g} {ms:.3f} ms ({g_ms / ms:.3f}x greedy)"
                      for g, ms in s1_ms.items()))

    # S2: a random draft proposes, the float tree verifies
    tag = "spec S2 (float target, random draft, gamma 4)"
    target, target_cpu = float_tree(params), float_tree(params_cpu)
    draft = init_params(cfg, seed=1, device=DEVICE)
    draft_cpu = init_params(cfg, seed=1, device="cpu")
    stats = []
    for i in range(len(audio)):
        out, mel, launches = counted(target, draft, i, 4)
        cpu = run(target_cpu, draft_cpu, mel.cpu(), 4, "cpu")
        check(tag, i, 4, out, cpu, launches, True)
        if int(out[3]) != 0:
            fail(f"{tag} utt{i:02d}: {int(out[3])} proposals accepted")
        stats.append(tuple(int(x) for x in out[1:]))
        if i == 0:
            counts["S2"] = launches
    _, traced, counted_ = traced_run(torch, lambda: run(target, draft,
                                                        mels[3], 4))
    want = spec_launches(cfg, stats[3][1], 4, True)
    if traced != counted_ or any(counted_[k] != want[k] for k in counted_):
        fail(f"{tag}: the counters {counted_} differ from the profiler's "
             f"launches {traced} or from {want}")
    print(f"{tag}: 4/4 texts, (length, rounds, accepted) {stats}, equal to "
          f"the CPU's, 0 accepted; launches exact; a traced call's "
          f"launches {traced} equal the counters [{card}]")
    del target, draft

    # S3: the cost of a round (random weights accept ~0: one token a round)
    out, wall = run_module("whisper_trtllm_tpu_torch.benchmarks.spec_loop_cost",
                           300, ["--preset", "tiny.en", "--utts", "4",
                                 "--gammas", ",".join(map(str, SPEC_GAMMAS))])
    for line in out.strip().splitlines():
        print(f"spec S3 spec_loop_cost tiny.en bf16 [{card}]: {line}")
    print(f"spec S3: spec_loop_cost took {wall:.1f} s")
    torch.cuda.synchronize()
    return counts


# --------------------------------------------------------------------------
# phase 4b: the CLIs, the utilities, the runtime options and engine export
# --------------------------------------------------------------------------

CLIS_DIR = os.path.join(ROOT, "build", "smoke", "clis")
# K1's symbols beside those of K2, K5 and K6 (``KERNEL_SYMBOLS``)
ENGINE_SYMBOLS = {"flash_fwd": ("flash_fwd",), **KERNEL_SYMBOLS}
# an engine loaded and run in a fresh interpreter where importing the model
# code or the runtime fails: two calls on the exported tree (the second
# traced, replays only), three timed, one on a second tree
ENGINE_CHILD = r"""
import json, statistics, sys, time
sys.modules["whisper_trtllm_tpu_torch.models"] = None
sys.modules["whisper_trtllm_tpu_torch.runtime"] = None
sys.path.insert(0, {root!r})
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from whisper_trtllm_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
from whisper_trtllm_tpu_torch.utils.engine import load_engine
engine, ckpt, ckpt2, mel_path, symbols = sys.argv[1:6]
symbols = json.loads(symbols)
t0 = time.perf_counter()
eng = load_engine(engine)
out = {{"load_s": time.perf_counter() - t0}}
params, _ = load_checkpoint(ckpt)
params2, _ = load_checkpoint(ckpt2)
mel = torch.from_numpy(np.load(mel_path)).cuda()
def call(p):
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, lens = eng(p, mel)
    torch.cuda.synchronize()
    return toks.cpu().tolist(), lens.cpu().tolist(), time.perf_counter() - t
def loop():
    return {{"captures": eng.captures, "replays": eng.replays,
            "eager_steps": eng.eager_steps,
            "launches": {{k: f.launches for k, f in KERNELS.items()}}}}
reset_launch_counts()
out["tokens"], out["lengths"], out["first_s"] = call(params)
out["first"] = loop()
reset_launch_counts()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    toks, lens, _ = call(params)
out["second"] = loop()
out["second"]["same"] = toks == out["tokens"] and lens == out["lengths"]
out["traced"] = {{k: sum(any(n in e.name for n in names) for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
                 for k, names in symbols.items()}}
out["replay_ms"] = statistics.median(call(params)[2] * 1e3 for _ in range(3))
out["tree2"] = call(params2)[:2]
out["model_modules"] = sorted(
    n for n in sys.modules if sys.modules[n] is not None and n.startswith(
        ("whisper_trtllm_tpu_torch.models", "whisper_trtllm_tpu_torch.runtime")))
print(json.dumps(out))
"""
# a fresh process that exports before anything decodes, then transcribes
EXPORT_FIRST_CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
from whisper_trtllm_tpu_torch.config import GenerationConfig
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
params, cfg = load_checkpoint(sys.argv[1])
sess = WhisperSession(params, cfg, GenerationConfig(max_new_tokens=32))
nbytes = sess.export_engine(sys.argv[3], batch=4)
toks, lens = sess.transcribe_features(np.load(sys.argv[2]))
print(json.dumps({{"bytes": nbytes, "tokens": toks.tolist(),
                  "lengths": lens.tolist()}}))
"""
# a fresh process whose session finds its kernels in a cache directory
CACHE_CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
from whisper_trtllm_tpu_torch.audio import pad_or_trim, read_wav
from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
from whisper_trtllm_tpu_torch.ops.kernels import _build
from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint
from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text
art, cache, wavs = sys.argv[1:4]
params, cfg = load_checkpoint(art)
sess = WhisperSession(params, cfg, GenerationConfig(max_new_tokens=32),
                      RuntimeConfig(persistent_cache_dir=cache))
audio = np.stack([pad_or_trim(read_wav(f"{{wavs}}/utt{{i:02d}}.wav"))
                  for i in range(4)])
toks, lens = sess.transcribe(audio)
print(json.dumps({{"texts": [ids_to_text(toks[i, :lens[i]]) for i in range(4)],
                  "build_dir": str(_build.BUILD_DIR),
                  "libs": sorted(lib._name for lib in _build._libs.values())}}))
"""
# the C6 loop at the toy preset's sizes (as tests/test_synthetic_asr.py)
TOY_LOOP = (
    ("synthetic_asr", ["make", "--out", "{d}", "--preset", "toy",
                       "--train-n", "6", "--eval-n", "4"]),
    ("finetune", ["--checkpoint", "{d}/ckpt_init", "--dataset",
                  "{d}/train.pkl", "--output", "{d}/ckpt_ft", "--epochs",
                  "1", "--batch", "3", "--lr", "3e-4", "--max-target-len",
                  "16"]),
    ("synthetic_asr", ["export-hf", "--checkpoint", "{d}/ckpt_ft",
                       "--hf-dir", "{d}/hf"]),
    ("accept", ["--hf-dir", "{d}/hf", "--audio-dir", "{d}/eval_wavs",
                "--max-new-tokens", "10", "--batch", "2", "--limit", "4",
                "--min-match-frac", "1.0", "--out", "{d}/accept.json"]),
)
INERT_OPTIONS = ("fp32_attention_softmax", "fp32_logits", "use_pallas")


class Child:
    """A subprocess of this phase, started at once, its output in a log
    under ``CLIS_DIR``; ``wait()`` fails the run unless it exits 0 within
    ``timeout`` and returns its output and wall seconds."""

    def __init__(self, name: str, args: list, timeout: int = 600):
        os.makedirs(CLIS_DIR, exist_ok=True)
        self.name, self.timeout = name, timeout
        self.log = os.path.join(CLIS_DIR, f"{name}.log")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.t0 = time.perf_counter()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                         env=env, stdout=f,
                                         stderr=subprocess.STDOUT)

    def wait(self):
        try:
            rc = self.proc.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = "timeout"
        wall = time.perf_counter() - self.t0
        with open(self.log) as f:
            out = f.read()
        if rc != 0:
            fail(f"clis {self.name} exited {rc} after {wall:.1f} s:\n"
                 f"{out[-4000:]}")
        return out, wall


def _json_line(out: str, name: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    fail(f"clis {name}: no JSON line in its output:\n{out[-2000:]}")


def _ids(tokens, lengths, eos) -> list:
    """The CLI's hypothesis ids: after the start token, EOS dropped."""
    out = []
    for row, n in zip(tokens, lengths):
        out.append([int(t) for t in row[1:int(n)] if int(t) != eos])
    return out


def clis_and_engine(torch, np, card):
    """The Whisper CLIs, the utilities, the runtime options and engine
    export (``runtime/export.py``, ``utils/engine.py``) on the artifact and
    the 4 bundled utterances; subprocesses run side by side with the
    in-process rows.

    C1: ``cli.transcribe`` at batch 4 over a (mel, text) pickle, fp32 and
    B (bf16, int8 KV): its printed ids equal the session's, the texts are
    the 4 expected, the WER of the normalized texts 0.0. C2: engines at
    batch 4 in B and E (the float tree: K6), each loaded and run in a fresh
    interpreter that cannot import the model code or the runtime: tokens
    and lengths the session's, a second tree (``init_params(seed=1)``
    through the same chain) the tokens of a session on it, the launches of
    a call equal to the session's and to the profiler's (K1, K2, K5 in B;
    K1, K5, K6 in E), one capture and a second call that only replays;
    the same for beam-search engines, K 4 in B and K 2 in E (their best
    hypothesis the session's; B's the 4 expected texts);
    and a fresh process that exports before any decode transcribes C1's
    fp32 tokens. C3: ``cli.warm_cache`` over a directory that holds phase
    1's libraries finds every kernel built and warms batch 1 and 4; a
    fresh process whose
    session has ``persistent_cache_dir`` there transcribes 4/4 and runs no
    ``nvcc`` (the libraries' mtimes unchanged, no new log). C4: B with each
    inert option (``INERT_OPTIONS``) set False: B's tokens and launches.
    C5: ``encode_with_intermediates`` within the fp32 tolerance of
    ``encode``; ``checked`` raises on a NaN behind a K5 launch;
    ``cli.visualize --stage all`` writes both graphs and a kernel list that
    names K1, K2 and K5. C6: the toy acceptance loop (``TOY_LOOP``):
    ``accept`` exits 0 with ``differential_frac`` 1.0. Ungated: C1's
    audio-s/s, the exports' seconds, an engine's first call against the
    session's first transcribe."""
    import dataclasses
    import pickle
    import shutil
    import threading

    from whisper_trtllm_tpu_torch.audio import (
        LogMelSpectrogram,
        pad_or_trim,
        read_wav,
    )
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.models.whisper import encode, init_params
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        _build,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import layer_norm
    from whisper_trtllm_tpu_torch.quantization import (
        quantize_vocab_embedding,
        weight_only_quantize,
    )
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from whisper_trtllm_tpu_torch.utils.debugging import (
        checked,
        encode_with_intermediates,
    )
    from whisper_trtllm_tpu_torch.utils.metrics import (
        get_text_normalizer,
        word_error_rate,
    )
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    shutil.rmtree(CLIS_DIR, ignore_errors=True)
    os.makedirs(CLIS_DIR)
    d = CLIS_DIR
    cache = os.path.join(d, "cache")
    toy = os.path.join(d, "toy")

    # C3 (a) and C6 start first: the warm-ups and the toy loop take
    # longest. The cache directory starts with phase 1's libraries (the
    # same digests), so warm_cache finds them built: rebuilding them all
    # here took ~100 s of nvcc beside the toy loop and checked nothing
    # phase 1 does not
    os.makedirs(cache)
    for src in SOURCES:
        lib = _build.library_path(src)
        for f in (lib, lib.with_suffix(".log")):
            shutil.copy2(f, cache)
    warm = Child("warm_cache", [
        "-m", "whisper_trtllm_tpu_torch.cli.warm_cache", "--checkpoint",
        ARTIFACT, "--batch", "1", "4", "--gen-tokens", "48", "--cache-dir",
        cache], timeout=600)
    toy_out = {}

    def toy_loop():
        for i, (cli, args) in enumerate(TOY_LOOP):
            child = Child(f"toy{i}_{cli}", [
                "-m", f"whisper_trtllm_tpu_torch.cli.{cli}",
                *(a.format(d=toy) for a in args)], timeout=600)
            rc = child.proc.wait(timeout=600)
            toy_out[i] = (rc, open(child.log).read(),
                          time.perf_counter() - child.t0)
            if rc != 0:
                return

    toy_thread = threading.Thread(target=toy_loop)
    toy_thread.start()

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
    frontend = LogMelSpectrogram(cfg.num_mel_bins, device=DEVICE)
    with torch.inference_mode():
        mels = frontend(np.stack([pad_or_trim(read_wav(os.path.join(
            EVAL_DIR, f"utt{i:02d}.wav"))) for i in range(4)])).cpu().numpy()
    with open(os.path.join(d, "eval.pkl"), "wb") as f:
        pickle.dump(list(zip(mels, expected)), f)
    np.save(os.path.join(d, "mels.npy"), mels)

    # C1: the transcribe CLI, fp32 and B, beside the sessions
    cli_args = ["-m", "whisper_trtllm_tpu_torch.cli.transcribe",
                "--checkpoint", ARTIFACT, "--dataset",
                os.path.join(d, "eval.pkl"), "--batch", "4",
                "--max-new-tokens", "32"]
    c1 = {"fp32": Child("transcribe_fp32", cli_args),
          "B": Child("transcribe_B", cli_args + [
              "--dtype", "bfloat16", "--kv-cache-dtype", "int8"])}
    c2_first = Child("export_first", [
        "-c", EXPORT_FIRST_CHILD.format(root=ROOT), ARTIFACT,
        os.path.join(d, "mels.npy"), os.path.join(d, "first.engine")])
    gen = GenerationConfig(max_new_tokens=32)
    gen_b = GenerationConfig(max_new_tokens=32, kv_cache_dtype="int8")
    rt_b = RuntimeConfig(compute_dtype="bfloat16")
    normalize = get_text_normalizer()

    def counted(session):
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, lens = session.transcribe_features(mels)
        torch.cuda.synchronize()
        return (toks, lens, {k: f.launches for k, f in KERNELS.items()},
                time.perf_counter() - t0)

    sessions = {"fp32": WhisperSession(params, cfg, gen, device=DEVICE),
                "B": WhisperSession(params, cfg, gen_b, rt_b, device=DEVICE)}
    ref = {k: counted(s) for k, s in sessions.items()}
    for name, child in c1.items():
        out, wall = child.wait()
        printed = {}
        for line in out.splitlines():
            if line.startswith("[") and "] " in line:
                i, ids = line[1:].split("] ", 1)
                printed[int(i)] = [int(t) for t in ids.split()]
        toks, lens = ref[name][:2]
        want = _ids(toks, lens, cfg.eos_token_id)
        if [printed.get(i) for i in range(4)] != want:
            fail(f"clis C1 transcribe {name}: printed ids {printed} are not "
                 f"the session's {want}")
        texts = [ids_to_text(ids) for ids in want]
        wer = word_error_rate([normalize(t) for t in texts],
                              [normalize(t) for t in expected])
        if texts != expected or wer != 0.0:
            fail(f"clis C1 transcribe {name}: texts {texts} (WER {wer})")
        rate = [line for line in out.splitlines() if "audio-s/s" in line]
        print(f"clis C1 transcribe {name}: ids equal the session's, 4/4 "
              f"texts, WER {wer}; {rate[-1] if rate else '?'} (timed pass, "
              f"batch 4) [{card}]; the CLI took {wall:.1f} s")

    # C2: engines in B and E, run in fresh interpreters
    tree1 = {"B": params, "E": float_tree(params)}
    tree2_raw = init_params(cfg, seed=1, device="cpu")
    tree2 = {"B": quantize_vocab_embedding(weight_only_quantize(tree2_raw)),
             "E": tree2_raw}
    # (tree, generation, runtime): greedy in B and E; beam search, K 4 in
    # B (K2 at 16 lanes) and K 2 in E (K6 at 8 lanes)
    gens = {"B": ("B", gen_b, rt_b), "E": ("E", gen, None),
            "beamB": ("B", dataclasses.replace(gen_b, num_beams=4), rt_b),
            "beamE": ("E", dataclasses.replace(gen, num_beams=2), None)}
    engines = {}
    for name, (tree, g, rt) in gens.items():
        sess = sessions[name] if name == "B" else WhisperSession(
            tree1[tree], cfg, g, rt, device=DEVICE)
        first = ref[name] if name == "B" else counted(sess)
        second = counted(sess)
        if name.startswith("beam"):
            texts = [ids_to_text(ids) for ids in _ids(
                first[0], first[1], cfg.eos_token_id)]
            if name == "beamB" and texts != expected:
                fail(f"clis C2 engine {name}: the session's texts {texts}")
            print(f"clis C2 engine {name}: the session's best hypotheses "
                  f"{texts}")
        sess2 = WhisperSession(tree2[tree], cfg, g, rt, device=DEVICE)
        toks2, lens2 = sess2.transcribe_features(mels)
        t0 = time.perf_counter()
        nbytes = sess.export_engine(os.path.join(d, f"{name}.engine"),
                                    batch=4)
        export_s = time.perf_counter() - t0
        for tag, s in (("1", sess), ("2", sess2)):
            save_checkpoint(os.path.join(d, f"tree{name}{tag}"), s.params, cfg)
        engines[name] = dict(first=first, second=second, tree2=(toks2, lens2),
                             export_s=export_s, bytes=nbytes,
                             child=Child(f"engine_{name}", [
                                 "-c", ENGINE_CHILD.format(root=ROOT),
                                 os.path.join(d, f"{name}.engine"),
                                 os.path.join(d, f"tree{name}1"),
                                 os.path.join(d, f"tree{name}2"),
                                 os.path.join(d, "mels.npy"),
                                 json.dumps(ENGINE_SYMBOLS)]))
        del sess2

    # C4: the inert options, each alone, on B
    toks_b, lens_b, launches_b = ref["B"][:3]
    for opt in INERT_OPTIONS:
        s = WhisperSession(params, cfg, gen_b, RuntimeConfig(
            compute_dtype="bfloat16", **{opt: False}), device=DEVICE)
        toks, lens, launches, _ = counted(s)
        if not (np.array_equal(toks, toks_b) and np.array_equal(lens, lens_b)
                and launches == launches_b):
            fail(f"clis C4 {opt}=False: tokens or launches {launches} differ "
                 f"from B's default ({launches_b})")
        del s
    print(f"clis C4: B with each of {', '.join(INERT_OPTIONS)} set False "
          f"gives B's tokens and launches {launches_b}")

    # C5: intermediates, the NaN check, visualize
    vis = Child("visualize", [
        "-m", "whisper_trtllm_tpu_torch.cli.visualize", "--checkpoint",
        ARTIFACT, "--out", os.path.join(d, "graph"), "--stage", "all"])
    sess_a = sessions["fp32"]
    final, inter = encode_with_intermediates(sess_a.params, cfg, mels)
    want = sess_a.encode(mels)
    err = float((final.float() - want.float()).abs().max())
    shapes = (tuple(inter["conv_stem"].shape),
              tuple(inter["layer_outputs"].shape))
    if not err <= TOLERANCE["float32"] or shapes != (
            (4, cfg.max_source_positions, cfg.d_model),
            (cfg.encoder_layers, 4, cfg.max_source_positions, cfg.d_model)):
        fail(f"clis C5 encode_with_intermediates: max |err| {err}, shapes "
             f"{shapes}")
    x = torch.randn(4, cfg.d_model, device=DEVICE)
    scale = torch.ones(cfg.d_model, device=DEVICE)
    fn = checked(lambda t: layer_norm(t, scale) * 2.0)
    fn(x)
    x[1, 3] = float("nan")
    before = layer_norm.launches
    try:
        fn(x)
        fail("clis C5 checked: a NaN behind a K5 launch passed")
    except FloatingPointError as e:
        raised = str(e)
    if layer_norm.launches != before + 1:
        fail("clis C5 checked: K5 was not launched")
    print(f"clis C5: encode_with_intermediates max |err| {err} against "
          f"encode, conv_stem {shapes[0]}, layer_outputs {shapes[1]}; "
          f"checked raised on a NaN behind a K5 launch: {raised}")

    # C2 continued: the fresh interpreters' results
    for name, e in engines.items():
        out, wall = e["child"].wait()
        res = _json_line(out, f"engine_{name}")
        toks, lens, launches, first_s = e["first"]
        tag = f"clis C2 engine {name}"
        if res["model_modules"]:
            fail(f"{tag}: the loader imported {res['model_modules']}")
        if not (res["tokens"] == toks.tolist()
                and res["lengths"] == lens.tolist()):
            fail(f"{tag}: tokens or lengths differ from the session's")
        toks2, lens2 = e["tree2"]
        if res["tree2"] != [toks2.tolist(), lens2.tolist()]:
            fail(f"{tag}: the second tree's tokens differ from a session's "
                 f"on it")
        f1, f2 = res["first"], res["second"]
        if not (f1["captures"] == 1 and f2["captures"] == 1
                and f2["eager_steps"] == f1["eager_steps"]
                and f2["replays"] > f1["replays"] and f2["same"]):
            fail(f"{tag}: first call {f1}, second {f2}: not one capture "
                 f"then replays only")
        traced = res["traced"]
        used = {"B": ("flash_fwd", "decode_attn", "layer_norm"),
                "E": ("flash_fwd", "layer_norm",
                      "fused_decoder_layer_step")}[gens[name][0]]
        if not (f1["launches"] == launches
                and f2["launches"] == e["second"][2]
                and all(traced[k] == f2["launches"][k] for k in traced)
                and all(f2["launches"][k] > 0 for k in used)):
            fail(f"{tag}: launches {f1['launches']} then {f2['launches']} "
                 f"(traced {traced}); the session's {launches} then "
                 f"{e['second'][2]}")
        print(f"{tag}: {e['bytes']} bytes, exported in {e['export_s']:.2f} s; "
              f"a fresh interpreter without the model code loaded it in "
              f"{res['load_s']:.2f} s; tokens and lengths the session's, the "
              f"seed-1 tree's a session's on it; launches a call "
              f"{f2['launches']} equal to the session's and to the "
              f"profiler's {traced}; one capture, then replays only; first "
              f"call {res['first_s']:.3f} s (the session's first transcribe "
              f"{first_s:.3f} s), a replayed call {res['replay_ms']:.3f} ms "
              f"(the session's {e['second'][3] * 1e3:.3f} ms) [{card}]")
    out, _ = c2_first.wait()
    res = _json_line(out, "export_first")
    toks, lens = ref["fp32"][:2]
    if not (res["tokens"] == toks.tolist() and res["lengths"]
            == lens.tolist()):
        fail("clis C2: a process that exported before any decode then "
             "transcribed other tokens than C1's")
    print("clis C2: a fresh process that exported first transcribes C1's "
          "fp32 tokens")

    out, wall = vis.wait()
    files = [os.path.join(d, f"graph.{s}") for s in
             ("encode.fx.txt", "step.fx.txt", "kernels.txt")]
    txt = [open(p).read() for p in files]
    wrappers = dict(kv.rsplit(" ", 1) for kv in txt[2].splitlines()[1]
                    .removeprefix("# wrapper launches: ").split(", "))
    if not ("wtpu.flash_fwd" in txt[0] and "wtpu.layer_norm" in txt[0]
            and "wtpu.decode_attn" in txt[1]
            and all(int(wrappers[k]) > 0 for k in
                    ("flash_fwd", "decode_attn", "layer_norm"))
            and all(any(n in txt[2] for n in ENGINE_SYMBOLS[k]) for k in
                    ("flash_fwd", "decode_attn", "layer_norm"))):
        fail(f"clis C5 visualize: {[len(t) for t in txt]} chars; wrapper "
             f"launches {wrappers}")
    print(f"clis C5 visualize --stage all: {', '.join(os.path.basename(p) for p in files)} "
          f"({', '.join(str(len(t)) for t in txt)} chars), the kernel list "
          f"naming K1, K2 and K5 ({wrappers}); {wall:.1f} s")

    # C3 (b): a fresh process on the warmed cache runs no nvcc
    out, wall = warm.wait()
    warmed = [line for line in out.splitlines() if line.startswith("warmed")]
    libs = sorted(p for p in os.listdir(cache) if p.endswith(".so"))
    logs = sorted(p for p in os.listdir(cache) if p.endswith(".log"))
    mtimes = {p: os.stat(os.path.join(cache, p)).st_mtime_ns for p in libs}
    if len(warmed) != 2 or len(libs) < 7:
        fail(f"clis C3 warm_cache: {len(libs)} libraries, lines {warmed}")
    for line in out.splitlines():
        if line.startswith(("built", "warmed")):
            print(f"clis C3 warm_cache: {line} [{card}]")
    out, _ = Child("cache_child", ["-c", CACHE_CHILD.format(root=ROOT),
                                   ARTIFACT, cache, EVAL_DIR]).wait()
    res = _json_line(out, "cache_child")
    after = {p: os.stat(os.path.join(cache, p)).st_mtime_ns for p in libs}
    if not (res["texts"] == expected and after == mtimes
            and sorted(p for p in os.listdir(cache) if p.endswith(".log"))
            == logs and res["build_dir"] == os.path.realpath(cache)
            and res["libs"] and all(p.startswith(os.path.realpath(cache))
                                    for p in res["libs"])):
        fail(f"clis C3: the cached session gave {res}")
    print(f"clis C3: warm_cache built {len(libs)} libraries in {wall:.1f} s "
          f"with its warm-ups; a fresh session with persistent_cache_dir "
          f"there loaded {len(res['libs'])} of them, ran no nvcc and "
          f"transcribed 4/4")

    # C6: the toy acceptance loop
    toy_thread.join(timeout=900)
    for i, (cli, _) in enumerate(TOY_LOOP):
        rc, out, wall = toy_out.get(i, ("not run", "", 0.0))
        if rc != 0:
            fail(f"clis C6 {cli} exited {rc}:\n{out[-4000:]}")
    with open(os.path.join(toy, "accept.json")) as f:
        report = json.load(f)
    if report.get("differential_frac") != 1.0 or not report.get("pass"):
        fail(f"clis C6 accept: {report}")
    print(f"clis C6 toy loop (make, finetune 1 epoch, export-hf, accept): "
          f"differential_frac {report['differential_frac']}, "
          f"{sum(w for _, _, w in toy_out.values()):.1f} s in all")
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phase 5: training
# --------------------------------------------------------------------------

TRAIN_LEN = 32  # max_target_len: the decoder runs 31 positions
# The card runs the step in full fp32 (no TF32), but its products sum in
# another order: its logits differ from the CPU's by ~1.4e-5 relative
# (2.5e-4 of values up to 18.5). The trained model's cross-entropy on its
# own utterances is ~0.015, and so near zero |dL| / L ~ 2 max|d logit|
# (8.2e-4 measured) and every gradient, a sum weighted by p - onehot,
# moves by as much (1.24e-3 of the worst leaf's largest |g|). A cut graph
# gives zero gradients or ones off by their own size.
LOSS_TOLERANCE = 2e-3  # relative
GRAD_TOLERANCE = 5e-3  # of each leaf's largest |g| on the CPU


def train_launches(cfg, guided: bool, remat: bool) -> dict:
    """Kernel launches of one training step on the card. K1 runs each
    encoder layer's self attention and, without guided attention, each
    decoder layer's cross attention (S = 31 < 768 keeps the causal self
    attention plain); K4 once for each K1 of the forward; K5 each of the
    2 + 3 LayerNorms a layer and the two final ones; remat runs each
    encoder layer's forward again in the backward."""
    le, ld = cfg.encoder_layers, cfg.decoder_layers
    enc_fwd = le * (2 if remat else 1)
    cross = 0 if guided else ld
    return {"flash_fwd": enc_fwd + cross, "flash_bwd": le + cross,
            "decode_attn": 0, "stft_log_mel": 0,
            "layer_norm": 2 * enc_fwd + 1 + 3 * ld + 1,
            "fused_decoder_layer_step": 0, "cross_decode_mha": 0}


def training(torch, np, card):
    """Returns the launch counts of one step of (a)."""
    import pickle

    from whisper_trtllm_tpu_torch.audio import (
        log_mel_spectrogram,
        pad_or_trim,
        read_wav,
    )
    from whisper_trtllm_tpu_torch.cli.finetune import _pad_tokens
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.training import (
        loss_and_grads,
        make_train_step,
    )
    from whisper_trtllm_tpu_torch.training.train import tree_leaves, tree_map
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from whisper_trtllm_tpu_torch.utils.vocab import WORD_ID_BASE, WORDS

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        texts = json.load(f)["texts"]
    audio = np.stack([pad_or_trim(read_wav(os.path.join(
        EVAL_DIR, f"utt{i:02d}.wav"))) for i in range(len(texts))])
    mel = log_mel_spectrogram(audio, device="cpu").numpy()
    seqs = [[50257, 50362] + [WORD_ID_BASE + WORDS.index(w)
                              for w in text.split()] + [50256]
            for text in texts]
    params_cpu, cfg = load_checkpoint(ARTIFACT, device="cpu")
    tokens, mask = _pad_tokens(seqs, cfg.pad_token_id, TRAIN_LEN)
    tag = f"train (float tree, batch {len(texts)}, {TRAIN_LEN} positions)"

    # (a) the gradients on the card against the CPU's
    tree_cpu = float_tree(params_cpu)
    loss_cpu, g_cpu = loss_and_grads(tree_cpu, cfg, mel, tokens, mask)
    loss_card, g_card = loss_and_grads(float_tree(load_checkpoint(
        ARTIFACT, device=DEVICE)[0]), cfg, mel, tokens, mask)
    worst, n_leaves = 0.0, 0
    for a, b in tree_leaves(tree_map(lambda a, b: (a.cpu(), b), g_card,
                                     g_cpu)):
        top, n_leaves = b.abs().max().item(), n_leaves + 1
        if not a.abs().max().item() > 0:
            fail(f"{tag}: a leaf {tuple(a.shape)} has a zero gradient on "
                 f"the card (the graph was cut)")
        rel = (a - b).abs().max().item() / top
        if not rel <= GRAD_TOLERANCE:
            fail(f"{tag}: a leaf {tuple(a.shape)}'s card gradient differs "
                 f"from the CPU's by {rel:.3e} of its largest |g|")
        worst = max(worst, rel)
    print(f"{tag} (a): loss card {float(loss_card):.6f} cpu "
          f"{float(loss_cpu):.6f}; {n_leaves} leaves, every card gradient "
          f"nonzero, max |card - cpu| = {worst:.3e} of the leaf's max |g| "
          f"(tol {GRAD_TOLERANCE})")

    # (a) one make_train_step step (AdamW, lr 1e-4), counted
    init, step = make_train_step(cfg)
    params = float_tree(load_checkpoint(ARTIFACT, device=DEVICE)[0])
    state = init(params)
    reset_launch_counts()
    _, _, loss = step(params, state, mel, tokens, mask)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    want = train_launches(cfg, guided=False, remat=False)
    if launches != want:
        fail(f"{tag}: one step's kernel launches {launches}, expected {want}")
    loss_rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    if not loss_rel <= LOSS_TOLERANCE:
        fail(f"{tag}: the step's loss {float(loss)} differs from the CPU's "
             f"{float(loss_cpu)} by {loss_rel:.3e} relative (tol "
             f"{LOSS_TOLERANCE})")
    print(f"{tag} (a) one step's loss {float(loss):.6f} against the CPU's: "
          f"{loss_rel:.3e} relative (tol {LOSS_TOLERANCE}); launches "
          f"{launches}")

    # (b) three steps on the transcripts rotated by one utterance
    rotated, rot_mask = _pad_tokens(seqs[1:] + seqs[:1], cfg.pad_token_id,
                                    TRAIN_LEN)
    params = float_tree(load_checkpoint(ARTIFACT, device=DEVICE)[0])
    state = init(params)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, mel, rotated, rot_mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f"{tag}: losses over three steps {losses} do not fall")
    print(f"{tag} (b) losses over 3 AdamW steps at lr 1e-4 on the rotated "
          f"transcripts: {losses}; step ms "
          f"{', '.join(f'{t:.2f}' for t in times)} (the first includes "
          f"first-call set-up); peak device memory {peak} bytes, weights "
          f"and optimizer state included [{card}]")

    # (c) the fine-tuning CLI, 3 epochs with remat and guided attention
    work = os.path.join(ROOT, "build", "smoke")
    save_checkpoint(os.path.join(work, "float"), tree_cpu, cfg)
    with open(os.path.join(work, "train.pkl"), "wb") as f:
        pickle.dump([(mel[i], seqs[i]) for i in range(len(seqs))], f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.finetune",
         "--checkpoint", os.path.join(work, "float"), "--dataset",
         os.path.join(work, "train.pkl"), "--output",
         os.path.join(work, "finetuned"), "--epochs", "3", "--batch",
         str(len(seqs)), "--lr", "1e-4", "--max-target-len", str(TRAIN_LEN),
         "--remat", "--guided-attn", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"finetune exited {out.returncode}:\n{out.stderr[-4000:]}")
    for line in out.stdout.splitlines():
        print(f"finetune: {line}")
    got = json.loads(out.stdout.split("kernel launches ")[1].splitlines()[0])
    want_ft = {k: 3 * n for k, n in train_launches(
        cfg, guided=True, remat=True).items()}
    if got != want_ft:
        fail(f"finetune: kernel launches {got}, expected {want_ft}")
    tuned, tuned_cfg = load_checkpoint(os.path.join(work, "finetuned"),
                                       device=DEVICE)
    moved = 0.0
    for a, b in tree_leaves(tree_map(lambda a, b: (a.cpu(), b), tuned,
                                     tree_cpu)):
        if not bool(torch.isfinite(a).all()):
            fail("finetune: the checkpoint holds non-finite weights")
        moved = max(moved, (a - b).abs().max().item())
    if tuned_cfg != cfg or not moved > 0:
        fail("finetune: the reloaded checkpoint is not the tuned model")
    print(f"finetune: 3 epochs (--remat --guided-attn 1) in {wall:.1f} s of "
          f"wall time (process start and build load included); launches "
          f"{got} as expected; checkpoint reloaded, largest weight change "
          f"{moved:.3e} [{card}]")
    return launches


# --------------------------------------------------------------------------
# phase 5b: data and tensor parallelism on torch.distributed
# --------------------------------------------------------------------------

# the heads a rank holds where tensor parallelism cuts the published sizes
# (torch.chunk semantics: ceil(H / tp) a rank, the last fewer): tiny.en's 6
# over 8 (1 a rank), large-v3's 20 over 8 (3) and over 4 (5)
LOCAL_HEADS = [(1, "6 heads over 8"), (3, "20 heads over 8"),
               (5, "20 heads over 4")]
# the one-device and the 1x1 mesh's train steps run the same kernels on the
# same values; where the embedding's gradient sums its rows in another
# order (a scatter with accumulation), Adam turns a last-bit difference of
# a gradient near its eps (1e-8) into a step difference of a few 1e-6: the
# parameters are held to 1e-6 where |g| >= ADAM_FLOOR, to a tenth of lr
# below, as in the CPU tests (tests/test_torch_parallel_train.py)
ADAM_FLOOR = 1e-6


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_local_heads(torch, rng, card):
    """K1 and K4 at batch 4, S = T = 1500, dh 64 and K2's cross case (T
    1504, 1500 valid) at each of ``LOCAL_HEADS``' head counts, against
    their plain versions within the limits of their phase-2 checks: K1 and
    K4 in fp32 and bf16, K2 with a float cache in fp32 and at the serving
    precision (int8 T-minor cache, bf16 q). Then a call of each with no
    head launches nothing. Returns {kernel: [row, ...]}."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.attention import quantize_kv
    from whisper_trtllm_tpu_torch.ops.kernels import (
        attention_reference,
        decode_attention_reference,
        decode_attn,
        flash_attention_backward_reference,
        flash_bwd,
        flash_fwd,
    )

    b, s, dh, t, valid = 4, 1500, 64, 1504, 1500
    out = {"flash_fwd": [], "flash_bwd": [], "decode_attn": []}

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape) * scale

    for h, why in LOCAL_HEADS:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            item = torch.tensor([], dtype=dtype).element_size()
            tol = TOLERANCE[dn]
            sets = []
            for _ in range(n_sets(4 * b * h * s * dh * item)):
                x = [a.to(dtype) for a in (
                    normal(b, h, s, dh, scale=1 / math.sqrt(dh)),
                    normal(b, h, s, dh), normal(b, h, s, dh),
                    normal(b, h, s, dh))]
                _, lse = flash_fwd(*x[:3], with_lse=True)
                sets.append((*x[:3], lse, x[3]))
            q, k, v, lse, do = sets[0]
            # K1
            err = (flash_fwd(q, k, v).float()
                   - attention_reference(q, k, v).float()).abs().max().item()
            if not err <= tol:
                fail(f"flash_fwd at {h} local heads {dn}: max |kernel - "
                     f"plain| = {err} > {tol}")
            ms = time_ms(torch, lambda q, k, v, *_: flash_fwd(q, k, v),
                         sets, 10)
            plain = time_ms(torch, lambda q, k, v, *_: attention_reference(
                q, k, v), sets, 10)
            lib = time_ms(torch, lambda q, k, v, *_:
                          F.scaled_dot_product_attention(q, k, v, scale=1.0),
                          sets, 10)
            b_ms, b_by = bound(4 * b * h * s * dh * item,
                               4.0 * b * h * s * s * dh, dn,
                               FLASH_PEAK_FLOPS)
            row = dict(heads=h, dtype=dn, max_abs_err=err, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by)
            out["flash_fwd"].append(row)
            print(f"kernel flash_fwd local heads {h} ({why}) {dn} B={b} "
                  f"S=T={s} dh={dh}: max_abs_err={err:.3e} (tol {tol}) "
                  f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            # K4
            got = flash_bwd(q, k, v, lse, do)
            ref = flash_attention_backward_reference(q, k, v, do)
            torch.cuda.synchronize()
            err = 0.0
            for what, g, r in zip(("dq", "dk", "dv"), got, ref):
                diff = (g.float() - r.float()).abs()
                e = diff.max().item()
                if dtype == torch.float32:
                    bad = e > tol * max(r.abs().max().item(), 1.0)
                else:
                    bad = (diff / r.float().abs().clamp(min=1)).max().item() \
                        > tol
                if not math.isfinite(e) or bad:
                    fail(f"flash_bwd at {h} local heads {dn} {what}: max "
                         f"|kernel - plain| = {e} beyond {tol}")
                err = max(err, e)
            ms = time_ms(torch, lambda *a: flash_bwd(*a), sets, 5)
            plain = time_ms(torch, lambda q, k, v, lse, do:
                            flash_attention_backward_reference(q, k, v, do),
                            sets, 5)
            lib_sets = []
            for q_, k_, v_, _, do_ in sets:
                leaves = [x.detach().requires_grad_(True) for x in
                          (q_, k_, v_)]
                lib_sets.append((F.scaled_dot_product_attention(
                    *leaves, scale=1.0), leaves, do_))
            lib = time_ms(torch, lambda o, leaves, do: torch.autograd.grad(
                o, leaves, do, retain_graph=True), lib_sets, 5)
            b_ms, b_by = bound((7 * b * h * s * dh) * item + 4 * b * h * s,
                               10.0 * b * h * s * s * dh, dn,
                               FLASH_PEAK_FLOPS)
            out["flash_bwd"].append(dict(
                heads=h, dtype=dn, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by))
            print(f"kernel flash_bwd local heads {h} ({why}) {dn} B={b} "
                  f"S=T={s} dh={dh}: max_abs_err={err:.3e} (tol {tol}) "
                  f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            del sets, lib_sets
        # K2's cross case: a float cache in fp32, the serving precision
        vlt = torch.tensor(valid, dtype=torch.int32, device=DEVICE)
        for kind in ("float32", "int8 bhdt bf16 q"):
            quant = kind != "float32"
            dtype = torch.bfloat16 if quant else torch.float32
            dn = str(dtype).split(".")[1]
            sets = []
            for _ in range(n_sets(2 * b * h * t * dh * (1 if quant else 4))):
                q = normal(b, h, 1, dh, scale=1 / math.sqrt(dh)).to(dtype)
                k, v = normal(b, h, t, dh), normal(b, h, t, dh)
                if quant:
                    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                    sets.append((q, kq.transpose(-1, -2).contiguous(),
                                 vq.transpose(-1, -2).contiguous(), ks, vs))
                else:
                    sets.append((q, k, v, None, None))

            def kernel(q, k, v, ks, vs):
                return decode_attn(q, k, v, vlt, ks, vs, quant)

            def plain_fn(q, k, v, ks, vs):
                return decode_attention_reference(q, k, v, vlt, k_scale=ks,
                                                  v_scale=vs, t_major=quant)

            err = (kernel(*sets[0]).float()
                   - plain_fn(*sets[0]).float()).abs().max().item()
            if not err <= TOLERANCE[dn]:
                fail(f"decode_attn cross at {h} local heads {kind}: max "
                     f"|kernel - plain| = {err} > {TOLERANCE[dn]}")
            ms = time_ms(torch, kernel, sets, 100)
            plain = time_ms(torch, plain_fn, sets, 100)
            lib = None if quant else time_ms(
                torch, lambda q, k, v, *_: F.scaled_dot_product_attention(
                    q, k[:, :, :valid], v[:, :, :valid], scale=1.0),
                sets, 100)
            rows = b * h * valid
            # q and out, the rows read (1-byte values and fp32 scales, or
            # fp32 values), the valid length
            nbytes = (2 * b * h * dh * dtype.itemsize + 2 * rows * (dh + 4)
                      if quant else (2 * b * h * dh + 2 * rows * dh) * 4) + 4
            b_ms, b_by = bound(nbytes, 4.0 * rows * dh, "float32")
            out["decode_attn"].append(dict(
                heads=h, dtype=kind, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by))
            print(f"kernel decode_attn cross local heads {h} ({why}) {kind} "
                  f"B={b} T={t} valid_len={valid} dh={dh} "
                  f"{_split_note(sets[0][0], sets[0][1], quant)}: "
                  f"max_abs_err={err:.3e} (tol {TOLERANCE[dn]}) ms={ms:.4f} "
                  f"plain_ms={plain:.4f} library_ms="
                  f"{'none' if lib is None else f'{lib:.4f}'} "
                  f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
            del sets

    # a rank with no heads launches nothing: a grid of no blocks is a
    # launch error
    before = {f: f.launches for f in (flash_fwd, flash_bwd, decode_attn)}
    q = torch.zeros((b, 0, s, dh), device=DEVICE)
    o, lse = flash_fwd(q, q, q, with_lse=True)
    grads = flash_bwd(q, q, q, lse, o)
    qd = torch.zeros((b, 0, 1, dh), device=DEVICE)
    od = decode_attn(qd, q, q, vlt)
    torch.cuda.synchronize()
    if {f: f.launches for f in before} != before or o.shape != q.shape or \
            any(g.shape != q.shape for g in grads) or od.shape != qd.shape:
        fail("K1, K4 or K2 launched, or gave a wrong shape, with no heads")
    print("kernels with no heads: K1, K4 and K2 returned their empty "
          "outputs and launched nothing")
    return out


def parallel(torch, np, card):
    """Phase 5b (see the module docstring); returns ``check_local_heads``'
    rows."""
    import datetime
    import torch.distributed as dist

    from whisper_trtllm_tpu_torch.audio import (
        log_mel_spectrogram,
        pad_or_trim,
        read_wav,
    )
    from whisper_trtllm_tpu_torch.cli.finetune import _pad_tokens
    from whisper_trtllm_tpu_torch.config import (
        GenerationConfig,
        MeshConfig,
        RuntimeConfig,
    )
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.parallel import (
        check_devices,
        collectives,
        initialize_distributed,
        make_mesh,
        shard_params,
    )
    from whisper_trtllm_tpu_torch.parallel.partition import leaves
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.training import (
        loss_and_grads,
        make_train_step,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        load_sharded,
        save_sharded,
    )
    from whisper_trtllm_tpu_torch.utils.vocab import WORD_ID_BASE, WORDS, \
        ids_to_text

    initialize_distributed(
        init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=120))
    try:
        if dist.get_backend() != "nccl":
            fail(f"the card's process group runs {dist.get_backend()}")
        mesh = make_mesh(MeshConfig(1, 1))
        report = check_devices(mesh)
        print(f"parallel: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
              f", world of 1, mesh data=1 model=1: check_devices {report}")
        if report != {"devices": 1, "ok": True}:
            fail(f"check_devices: {report}")

        with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
            texts = json.load(f)["texts"]
        audio = np.stack([pad_or_trim(read_wav(os.path.join(
            EVAL_DIR, f"utt{i:02d}.wav"))) for i in range(len(texts))])
        params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
        for name in ("A", "B"):
            _, compute, kv, layout, _, _ = CONFIGS[name]
            gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                                   cross_kv_layout=layout)
            rt = RuntimeConfig(compute_dtype=compute)
            runs = {}
            for key, m in (("one device", None), ("mesh 1x1", mesh)):
                session = WhisperSession(params, cfg, gen, rt, mesh=m,
                                         device=DEVICE)
                reset_launch_counts()
                collectives.reset_counts()
                tokens, lengths = session.transcribe(audio)
                torch.cuda.synchronize()
                runs[key] = (tokens, lengths, {
                    k: fn.launches for k, fn in KERNELS.items()},
                    dict(collectives.COUNTS))
                del session
            (t0_, l0, n0, _), (t1, l1, n1, c1) = runs.values()
            got = [ids_to_text(t1[i, :l1[i]]) for i in range(len(texts))]
            if got != texts:
                fail(f"parallel session {name}: texts {got}")
            if not (np.array_equal(t0_, t1) and np.array_equal(l0, l1)):
                fail(f"parallel session {name}: tokens differ from the "
                     f"one-device session's")
            if n0 != n1 or any(c1.values()):
                fail(f"parallel session {name}: launches {n1} against "
                     f"{n0}, collectives {c1}")
            print(f"parallel session {name} over the 1x1 mesh: the 4 texts, "
                  f"tokens equal to the one-device session's, launches "
                  f"{n1} equal to its, collectives {c1}")

        # a sampled decode with the batch cut over the mesh's data axis:
        # each row's draw keyed by its global lane (the rank's first row
        # plus its own), so the mesh draws the one-device tokens
        _, compute, kv, layout, _, _ = CONFIGS["A"]
        gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                               cross_kv_layout=layout, **SAMPLED)
        rt = RuntimeConfig(compute_dtype=compute)
        sampled = [WhisperSession(params, cfg, gen, rt, mesh=m,
                                  device=DEVICE).transcribe(audio)
                   for m in (None, mesh)]
        if not all(np.array_equal(a, b) for a, b in zip(*sampled)):
            fail("parallel sampled session over the 1x1 mesh: tokens differ "
                 "from the one-device session's")
        print(f"parallel sampled session A ({SAMPLED}) over the 1x1 mesh: "
              f"tokens and lengths equal to the one-device session's "
              f"(lengths {sampled[1][1].tolist()})")

        # one train step over the 1x1 mesh against the one-device step
        mel = log_mel_spectrogram(audio, device="cpu").numpy()
        seqs = [[50257, 50362] + [WORD_ID_BASE + WORDS.index(w)
                                  for w in text.split()] + [50256]
                for text in texts]
        tokens, mask = _pad_tokens(seqs, cfg.pad_token_id, TRAIN_LEN)
        one = float_tree(load_checkpoint(ARTIFACT, device=DEVICE)[0])
        _, grads = loss_and_grads(one, cfg, mel, tokens, mask)
        grads = dict(leaves(grads))
        init, step = make_train_step(cfg)
        one, _, loss_one = step(one, init(one), mel, tokens, mask)
        meshed = shard_params(float_tree(load_checkpoint(
            ARTIFACT, device=DEVICE)[0]), mesh, cfg=cfg)
        init, step = make_train_step(cfg, mesh=mesh)
        reset_launch_counts()
        meshed, _, loss = step(meshed, init(meshed), mel, tokens, mask)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        same = dict(leaves(one))
        unequal, worst = 0, 0.0
        for p, t in leaves(meshed):
            diff = (t - same[p]).abs()
            unequal += int((diff > 0).sum())
            floor = grads[p].abs() >= ADAM_FLOOR
            worst = max(worst, diff.max().item())
            if bool((diff > torch.where(floor, 1e-6, 1e-5)).any()):
                fail(f"parallel train step: {p} differs from the one-device "
                     f"step's by {diff.max().item()}")
        loss_rel = abs(loss.item() - loss_one.item()) / abs(loss_one.item())
        if not loss_rel <= 1e-6:
            fail(f"parallel train step: loss {loss.item()} against "
                 f"{loss_one.item()}")
        if launches != train_launches(cfg, guided=False, remat=False):
            fail(f"parallel train step: launches {launches}")
        print(f"parallel train step over the 1x1 mesh: loss {loss.item()} "
              f"against {loss_one.item()} on one device; parameters after "
              f"the AdamW step: {unequal} of {sum(t.numel() for _, t in leaves(one))} "
              f"differ, by at most {worst:.3e} (tol 1e-6, 1e-5 where "
              f"|g| < {ADAM_FLOOR}); launches {launches}")

        # the sharded checkpoint
        path = os.path.join(ROOT, "build", "smoke", "dcp")
        t0 = time.perf_counter()
        save_sharded(path, meshed)
        back = load_sharded(path, shardings=mesh)
        wall = time.perf_counter() - t0
        same = dict(leaves(meshed))
        if set(dict(leaves(back))) != set(same) or not all(
                t.is_cuda and torch.equal(t, same[p])
                for p, t in leaves(back)):
            fail("parallel: the DCP checkpoint did not round-trip bit-equal")
        print(f"parallel checkpoint: save_sharded/load_sharded of the float "
              f"tree ({len(same)} leaves) round-trip bit-equal onto the card "
              f"in {wall:.2f} s")
        del one, meshed, back
    finally:
        dist.destroy_process_group()

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m",
         "whisper_trtllm_tpu_torch.benchmarks.scaling", "--devices", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    if out.returncode != 0:
        fail(f"scaling exited {out.returncode}:\n{out.stderr[-4000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    if len(rows) != 1 or rows[0].get("scaling_efficiency") != 1.0:
        fail(f"scaling: rows {rows}")
    print(f"parallel scaling (torchrun --nproc-per-node 1): {rows[0]} "
          f"[{card}]")
    return check_local_heads(torch, CardRng(torch, "local heads"), card)


# --------------------------------------------------------------------------
# phase 6: the bench
# --------------------------------------------------------------------------

# a share of a bound above 1 means a wrong count or a wrong timer
MAX_BOUND_SHARE = 1.05


def _numbers(tree, path=""):
    """(path, value) of every number in a JSON tree, booleans apart."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}/{k}")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


# the benchmark grid's beam row: tiny.en, bf16, this batch and K
BENCH_BEAM_BATCH = 8
BENCH_BEAMS = 4


def beam_step_stats(torch, np, card):
    """The beam row's session in this process beside its greedy twin
    (tiny.en, bf16, batch ``BENCH_BEAM_BATCH``, EOS disabled: 48 steps):
    ms a decode step, host µs a replay (queued behind a spin of the card),
    the idle share over a transcribe (one traced call's device time over
    the median untraced one), peak device memory over the transcribes;
    for the beams, the cache reorder's share of a step: the reorder alone
    (``beam.reorder_caches`` on the entry's caches) timed with events,
    over the ms a step, and the index_select kernels' device time in a
    traced decode."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.config import (
        GenerationConfig,
        RuntimeConfig,
        WhisperConfig,
    )
    from whisper_trtllm_tpu_torch.models.whisper import init_params
    from whisper_trtllm_tpu_torch.runtime import beam
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.profile_transcribe import _device_us

    cfg = dataclasses.replace(WhisperConfig.tiny_en(), eos_token_id=-1)
    params = init_params(cfg, seed=0, device="cpu")
    mel = np.random.default_rng(SEED).standard_normal(
        (BENCH_BEAM_BATCH, 2 * cfg.max_source_positions, cfg.num_mel_bins)
    ).astype(np.float32)
    for k in (1, BENCH_BEAMS):
        tag = f"bench beams K {k} (tiny.en, bf16, batch {BENCH_BEAM_BATCH})"
        gen = GenerationConfig(max_new_tokens=48, num_beams=k)
        session = WhisperSession(params, cfg, gen,
                                 RuntimeConfig(compute_dtype="bfloat16"),
                                 device=DEVICE)
        session.transcribe_features(mel)  # warm-up: captures the step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, tr, tr_lo, tr_hi = timed(
            torch, lambda: session.transcribe_features(mel), 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with torch.inference_mode():
            enc = session.encode(mel)
        if k > 1:
            def decode():
                return beam.beam_decode(session.params, cfg, enc, gen)
        else:
            def decode():
                return gen_rt.greedy_decode(session.params, cfg, enc, gen)
        gen_rt.reset_loop_counts()
        _, de, de_lo, de_hi = timed(torch, decode, 3)
        steps = gen_rt.LOOP.replays / 3
        if steps != 48 or gen_rt.LOOP.eager_steps:
            fail(f"{tag}: {gen_rt.LOOP.replays} replays and "
                 f"{gen_rt.LOOP.eager_steps} eager steps in 3 decodes")
        step_ms = de / steps
        entry = next(reversed(gen_rt._GRAPHS.values()))
        reset = beam.reset_beam_state if k > 1 else gen_rt.reset_state
        with torch.inference_mode():
            reset(entry.state, cfg, entry.rules)
            rep, queued = host_us(torch, entry.replay, 40, SPIN_CYCLES)
            reset(entry.state, cfg, entry.rules)
        busy, _, _ = traced_run(torch,
                                lambda: session.transcribe_features(mel))
        print(f"{tag} [{card}]: transcribe {tr:.2f} ms ({tr_lo:.2f}.."
              f"{tr_hi:.2f}), decode {de:.2f} ms ({de_lo:.2f}..{de_hi:.2f}), "
              f"{step_ms:.4f} ms a step at {BENCH_BEAM_BATCH * k} lanes; host "
              f"{rep:.2f} us a replay "
              f"({'all queued' if queued else 'a replay waited'}); "
              f"idle share {1 - busy / tr:.3f} (device busy {busy:.2f} ms of "
              f"a traced transcribe); peak {peak:.3f} GiB allocated")
        if k > 1:
            # the reorder alone: 50 of them captured in one graph, so that
            # the time is the card's and not the launches' gaps
            s = entry.state
            src = torch.arange(BENCH_BEAM_BATCH * k, device=DEVICE)
            graph = torch.cuda.CUDAGraph()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with torch.inference_mode():
                beam.reorder_caches(s.self_kv, src)
                torch.cuda.synchronize()
                with torch.cuda.graph(graph):
                    for _ in range(50):
                        beam.reorder_caches(s.self_kv, src)
                graph.replay()
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize()
            reorder_ms = start.elapsed_time(end) / 50
            del graph
            cache_bytes = sum(c.numel() * c.element_size() for c in s.self_kv)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                decode()
                torch.cuda.synchronize()
            dev_events = [e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and not e.key.startswith("Activity Buffer")]
            total = sum(_device_us(e) for e in dev_events) / 1e3
            gather = sum(_device_us(e) for e in dev_events
                         if "indexSelect" in e.key) / 1e3
            print(f"{tag} cache reorder [{card}]: {reorder_ms:.4f} ms a step "
                  f"(graph-timed, {cache_bytes / 2 ** 20:.2f} MiB of self "
                  f"caches gathered, then copied back), "
                  f"{reorder_ms / step_ms:.3f} of a {step_ms:.4f} ms step; "
                  f"index_select kernels {gather:.2f} ms of {total:.2f} ms "
                  f"device time in a traced decode ({gather / total:.3f})")
            top = sorted(dev_events, key=_device_us, reverse=True)[:10]
            print(f"{tag} traced decode, device ms by kernel (of "
                  f"{total:.2f}) [{card}]: " + "; ".join(
                      f"{e.key[:60]} {_device_us(e) / 1e3:.2f} "
                      f"x{e.count}" for e in top))
        del session, enc, entry
        gen_rt.drop_graphs()


def bench_phase(torch, np, card):
    """Runs ``cli.bench --fp32`` and ``benchmarks.benchmark`` as
    subprocesses and checks their lines; then one headline pass in this
    process with the launches counted, the headline's batch split into its
    stages, and the card's idle share: one pass's device time under
    ``torch.profiler`` over the median of three passes not traced. Returns the launches of the headline pass (K1, K2, K3, K5) and of the
    benchmark CLI's batch-8 float32 row (K6)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.benchmarks.benchmark import timed_calls
    from whisper_trtllm_tpu_torch.cli import bench
    from whisper_trtllm_tpu_torch.config import WhisperConfig
    from whisper_trtllm_tpu_torch.models.whisper import model as wmodel
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.utils.profile_transcribe import _device_us

    # (a) the one-line bench; phase 3 wrote a fresh gpu_check record
    stdout, wall = run_module("whisper_trtllm_tpu_torch.cli.bench", 900,
                              ["--fp32"])
    line = json.loads(stdout.strip().splitlines()[-1])
    print(f"bench ({wall:.1f} s of wall time): {json.dumps(line)}")
    bad = [f"{p}={v}" for p, v in _numbers(line)
           if not (math.isfinite(v) and v > 0)]
    if bad:
        fail(f"bench: numbers not finite and positive: {bad}")
    if line["gpu_check"]["status"] != "pass":
        fail(f"bench: the gate did not pass: {line['gpu_check']}")
    for key in ("medium", "large"):
        sec = line.get(key)
        if not isinstance(sec, dict) or "skipped" in sec:
            fail(f"bench: the {key} section is missing or skipped: {sec}")
        if not sec["decode_roofline_frac"] <= MAX_BOUND_SHARE:
            fail(f"bench: {key} decode_roofline_frac "
                 f"{sec['decode_roofline_frac']} > {MAX_BOUND_SHARE}")
    if not (line["mfu"] is not None and 0 < line["mfu"] <= MAX_BOUND_SHARE):
        fail(f"bench: mfu {line['mfu']} not in (0, {MAX_BOUND_SHARE}]")

    # (b) the grid CLI: float weights and KV at batch <= 16 take K6 for
    # every decode layer, in fp32 and in bf16
    cfg = WhisperConfig.tiny_en()
    stdout, wall = run_module(
        "whisper_trtllm_tpu_torch.benchmarks.benchmark", 600,
        ["--model", "tiny.en", "--batch", "1", "8", "--dtype", "float32",
         "bfloat16"])
    rows = [json.loads(x) for x in stdout.strip().splitlines()]
    k6 = None
    for row in rows:
        print(f"benchmark: {json.dumps(row)}")
        want = transcribe_launches(cfg, row["gen_tokens"], row["iters"],
                                   fused=True, frontend=False)
        want = {k: n for k, n in want.items() if n}
        if row["launches"] != want:
            fail(f"benchmark {row['dtype']} batch {row['batch']}: launches "
                 f"{row['launches']}, expected {want}")
        if (row["dtype"], row["batch"]) == ("float32", 8):
            k6 = row["launches"]["fused_decoder_layer_step"]
    if len(rows) != 4 or k6 is None:
        fail(f"benchmark: expected 4 rows with float32 batch 8, got {rows}")
    print(f"benchmark: {len(rows)} rows in {wall:.1f} s of wall time; K6 "
          f"{cfg.decoder_layers} launches a decode step in every row")

    # (b') the grid CLI's beam row beside its --num-beams 1 twin (bf16,
    # batch 8): B·K = 32 lanes a step, past K6's 16, so K2 and K5
    stdout, wall = run_module(
        "whisper_trtllm_tpu_torch.benchmarks.benchmark", 600,
        ["--model", "tiny.en", "--batch", str(BENCH_BEAM_BATCH), "--dtype",
         "bfloat16", "--num-beams", str(BENCH_BEAMS)])
    beam_row = json.loads(stdout.strip().splitlines()[-1])
    print(f"benchmark: {json.dumps(beam_row)}")
    want = transcribe_launches(cfg, beam_row["gen_tokens"], beam_row["iters"],
                               fused=False, frontend=False)
    want = {k: n for k, n in want.items() if n}
    if beam_row["num_beams"] != BENCH_BEAMS or beam_row["launches"] != want:
        fail(f"benchmark beams: launches {beam_row['launches']}, expected "
             f"{want}")
    twin = next(r for r in rows if (r["dtype"], r["batch"])
                == ("bfloat16", BENCH_BEAM_BATCH))
    print(f"benchmark beams ({wall:.1f} s of wall time) [{card}]: K "
          f"{BENCH_BEAMS} p50 {beam_row['latency_ms_p50']:.2f} ms, "
          f"{beam_row['audio_s_per_s']:.2f} audio-s/s, peak "
          f"{beam_row['peak_mem_gib']:.3f} GiB; its greedy twin p50 "
          f"{twin['latency_ms_p50']:.2f} ms, {twin['audio_s_per_s']:.2f} "
          f"audio-s/s, peak {twin['peak_mem_gib']:.3f} GiB")
    beam_step_stats(torch, np, card)

    # (c) one headline pass in this process, counted
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    audio = [torch.from_numpy(
        rng.standard_normal((bench.BATCH, bench.N_SAMPLES)).astype(np.float32)
        * np.float32(0.1)).to(dev) for _ in range(bench.N_BATCHES)]
    session = bench.bench_session(cfg, "int8", "bfloat16", device=dev)

    def one_pass():
        return bench.run_pass(session, audio, frontend=True)

    one_pass()  # warm-up: captures the step
    reset_launch_counts()
    gen_rt.reset_loop_counts()
    _, pass_ms = timed_calls(one_pass, dev, 1, warmup=0)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    want = transcribe_launches(cfg, bench.GEN_TOKENS, bench.N_BATCHES,
                               fused=False, frontend=True)
    if launches != want:
        fail(f"bench headline pass: launches {launches}, expected {want}")
    # EOS disabled: each batch runs exactly its 48 steps, all replays
    if (gen_rt.LOOP.replays != bench.GEN_TOKENS * bench.N_BATCHES
            or gen_rt.LOOP.eager_steps):
        fail(f"bench headline pass: {gen_rt.LOOP.replays} replays and "
             f"{gen_rt.LOOP.eager_steps} eager steps, not "
             f"{bench.GEN_TOKENS} replays a batch")
    # two more passes, none traced: the wall time of the idle share (e)
    pass_ms += timed_calls(one_pass, dev, 2, warmup=0)[1]
    untraced_ms = statistics.median(pass_ms)
    print(f"bench headline pass in process ({bench.N_BATCHES} x batch "
          f"{bench.BATCH}, {bench.GEN_TOKENS} steps): {pass_ms[0]:.2f} ms, "
          f"launches {launches} as expected; 3 passes: median "
          f"{untraced_ms:.2f} ms ({min(pass_ms):.2f}..{max(pass_ms):.2f}) "
          f"[{card}]")

    # (d) where the headline batch's time goes (the passes above warmed
    # every stage up): median of 3 (min..max)
    gen = session.generation
    with torch.inference_mode():
        mel, fe, fe_lo, fe_hi = timed(
            torch, lambda: session.frontend(audio[0]), 3)
        enc, en, en_lo, en_hi = timed(torch, lambda: session.encode(mel), 3)
        _, cr, cr_lo, cr_hi = timed(torch, lambda: wmodel.compute_cross_kv(
            session.params, session.cfg, enc), 3)
        _, de, de_lo, de_hi = timed(torch, lambda: gen_rt.greedy_decode(
            session.params, session.cfg, enc, gen), 3)
    steps = bench.GEN_TOKENS
    print(f"bench headline batch stages (batch {bench.BATCH}, median of 3, "
          f"min..max) [{card}]: frontend {fe:.2f} ms ({fe_lo:.2f}..{fe_hi:.2f}), "
          f"encode {en:.2f} ms ({en_lo:.2f}..{en_hi:.2f}), greedy decode "
          f"{de:.2f} ms ({de_lo:.2f}..{de_hi:.2f}; cross K/V inside it "
          f"{cr:.2f} ms, {cr_lo:.2f}..{cr_hi:.2f}), {de / steps:.3f} ms a "
          f"decode step")
    step_host_costs(torch, session, enc, gen, "bench headline", card)

    # (e) the card's idle share over a headline pass: the device time of
    # one traced pass over the median untraced pass of (c), whose host
    # time the profiler's own does not inflate; the share against the
    # traced pass's wall beside it
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced_ms = timed_calls(one_pass, dev, 1, warmup=0)
    busy_ms = sum(_device_us(e) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")) / 1e3
    if not busy_ms > 0:
        fail("bench: the profiler traced no device time")
    print(f"bench headline pass [{card}]: device busy {busy_ms:.2f} ms "
          f"(traced), idle share {1 - busy_ms / untraced_ms:.3f} of the "
          f"median untraced pass ({untraced_ms:.2f} ms); "
          f"{1 - busy_ms / traced_ms[0]:.3f} of the traced pass's wall "
          f"({traced_ms[0]:.2f} ms, the profiler's cost included)")

    # (f) what the captured steps hold on the card: their static buffers
    # (state and cross cache), and the allocated bytes their drop frees
    leaves = gen_rt._decoder_leaves(session.params)
    static = sum(t.numel() * t.element_size()
                 for e in gen_rt._GRAPHS.values() if e.matches(leaves)
                 for t in (*e.state[:4], *e.state.self_kv, *e.cross_kv))
    del leaves
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    dropped = gen_rt.drop_graphs(session.params)
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated(dev)
    print(f"bench headline session [{card}]: {dropped} captured steps held "
          f"{static / 2 ** 30:.3f} GiB of static buffers; dropping them "
          f"freed {freed / 2 ** 30:.3f} GiB allocated")
    return launches, k6

# --------------------------------------------------------------------------
# phase 7: serving — the in-flight batcher, the HTTP daemon, load numbers
# --------------------------------------------------------------------------

# K2 at the in-flight batcher's shape: cli.serve's default lanes (8) and
# self cache (--max-new-tokens 224 + 1 rows), the lanes at lengths 1 + 32 i
# (1..225) in one launch; float and int8 caches, fp32 q (the batcher's
# precision: the weights as loaded)
BATCHER_K2 = dict(b=8, h=6, t=225, dh=64,
                  lens=[1 + 32 * i for i in range(8)])


def check_decode_batcher(torch, rng, card):
    """K2 at ``BATCHER_K2`` against its plain version; returns the float
    case's numbers with the int8 case's under "int8"."""
    import torch.nn.functional as F

    from whisper_trtllm_tpu_torch.ops.attention import quantize_kv
    from whisper_trtllm_tpu_torch.ops.kernels import (
        decode_attention_reference,
        decode_attn,
    )

    b, h, t, dh, lens = (BATCHER_K2[k] for k in ("b", "h", "t", "dh",
                                                  "lens"))
    vlt = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    mask = (torch.arange(t, device=DEVICE)[None, :]
            < vlt[:, None])[:, None, None, :]            # (B, 1, 1, T)
    rows = h * sum(lens)
    out = {}
    for kind in ("float", "int8"):
        sets = []
        for _ in range(n_sets(2 * b * h * t * dh * 4)):
            q = card_tensor(torch, rng.standard_normal(
                (b, h, 1, dh), dtype="float32") / math.sqrt(dh))
            k, v = (card_tensor(torch, rng.standard_normal(
                (b, h, t, dh), dtype="float32")) for _ in "kv")
            if kind == "int8":
                (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                sets.append((q, kq, vq, ks, vs))
            else:
                sets.append((q, k, v, None, None))

        def kern(q, k, v, ks, vs):
            return decode_attn(q, k, v, vlt, ks, vs, False)

        def plain(q, k, v, ks, vs):
            return decode_attention_reference(q, k, v, vlt, k_scale=ks,
                                              v_scale=vs)

        err = 0.0
        for args in sets[:2]:
            e = (kern(*args) - plain(*args)).abs().max().item()
            if not math.isfinite(e) or e > TOLERANCE["float32"]:
                fail(f"decode_attn batcher {kind}: max |kernel - plain| = "
                     f"{e} > {TOLERANCE['float32']}")
            err = max(err, e)
        ms = time_ms(torch, kern, sets, 200)
        plain_ms = time_ms(torch, plain, sets, 200)
        lib = None
        if kind == "float":
            lib = time_ms(torch, lambda q, k, v, ks, vs:
                          F.scaled_dot_product_attention(
                              q, k, v, attn_mask=mask, scale=1.0),
                          sets, 200)
            item = 4
            nbytes = 2 * b * h * dh * 4 + 2 * rows * dh * item + 4 * b
        else:
            nbytes = 2 * b * h * dh * 4 + 2 * rows * (dh + 4) + 4 * b
        # the rows these lanes read: each lane's own length
        b_ms, b_by = bound(nbytes, 4.0 * rows * dh, "float32")
        print(f"kernel decode_attn batcher {kind} q=float32 B={b} H={h} "
              f"T={t} dh={dh} valid_len={lens} "
              f"{_split_note(sets[0][0], sets[0][1], False)}: "
              f"max_abs_err={err:.3e} (tol {TOLERANCE['float32']}): "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{'none' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
        out[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        del sets
    row = out["float"]
    row["int8"] = out["int8"]
    return row


# name: (weights, kv_cache_dtype, cross_kv_layout, ids held to the CPU
# batcher's and the card's lockstep session's)
SERVE_CONFIGS = {
    "A": ("int8", "auto", "auto", True),
    "C": ("int8", "int8", "bhtd", True),
    "int8-auto": ("int8", "int8", "auto", False),
    "E": ("float", "auto", "auto", True),
}
SERVE_LANES, SERVE_SEGMENT = 2, 8
# the load numbers: the batcher as cli.serve builds it (8 lanes, 16 steps
# a segment, the weights as loaded, int8 KV T-minor), 64 requests
LOAD_LANES, LOAD_SEGMENT, LOAD_REQUESTS, LOAD_CLIENTS = 8, 16, 64, 16


def serve_launches(cfg, steps: int, requests: int) -> dict:
    """Kernel launches of a batcher that ran ``steps`` steps and served
    ``requests`` requests: per request K3 once (its frontend), K1 once and
    K5 twice an encoder layer and K5 once after; per step K2 twice and K5
    three times a decoder layer and K5 once after; no K6."""
    le, ld = cfg.encoder_layers, cfg.decoder_layers
    return {"flash_fwd": le * requests, "flash_bwd": 0,
            "decode_attn": 2 * ld * steps, "stft_log_mel": requests,
            "layer_norm": (2 * le + 1) * requests + (3 * ld + 1) * steps,
            "fused_decoder_layer_step": 0, "cross_decode_mha": 0}


def _drain(b, waves, staggered=False):
    """Submit ``waves`` (raw audio) to batcher ``b`` and run it to the end;
    staggered: two, one segment, then the rest. Returns the rows."""
    if staggered:
        rids = [b.submit_audio(w) for w in waves[:2]]
        b._retire_and_admit()
        b._dispatch_segment()
        rids += [b.submit_audio(w) for w in waves[2:]]
    else:
        rids = [b.submit_audio(w) for w in waves]
    b.run()
    return [b.fetch(r) for r in rids]


def _same_rows(np, got, want) -> bool:
    return len(got) == len(want) and all(
        g is not None and np.array_equal(g, w) for g, w in zip(got, want))


class Daemon:
    """``python -m whisper_trtllm_tpu_torch.cli.serve`` on the artifact
    (int8 KV, 32 new tokens) as a subprocess on a port the OS picks, its
    output in ``build/smoke/serve_<backend>.log``; ``stop()`` ends it."""

    def __init__(self, backend: str):
        from whisper_trtllm_tpu_torch.benchmarks import serve_loadtest

        self.backend = backend
        os.makedirs(os.path.join(ROOT, "build", "smoke"), exist_ok=True)
        self.log = os.path.join(ROOT, "build", "smoke",
                                f"serve_{backend}.log")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.t0 = time.perf_counter()
        self.proc = serve_loadtest.Daemon(
            [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.serve",
             "--checkpoint", ARTIFACT, "--backend", backend, "--port", "0",
             "--kv-cache-dtype", "int8", "--max-new-tokens", "32"],
            self.log, env)

    def fail(self, msg: str) -> None:
        with open(self.log) as f:
            fail(f"serve {self.backend}: {msg}\n{f.read()[-4000:]}")

    def stop(self) -> None:
        self.proc.stop()


def http_backend(card, daemon: Daemon, blobs, expected):
    """The 4 WAVs POSTed at once to ``daemon`` must give the 4 texts, a
    malformed WAV 400."""
    import http.client
    import threading

    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    backend = daemon.backend
    try:
        daemon.proc.wait_healthy(300)
    except RuntimeError as e:
        daemon.fail(str(e))
    port = daemon.proc.port
    up = time.perf_counter() - daemon.t0

    def post(body):
        c = http.client.HTTPConnection("localhost", port, timeout=300)
        c.request("POST", "/transcribe", body=body)
        r = c.getresponse()
        return r.status, json.loads(r.read())

    replies = [None] * len(blobs)

    def client(i):
        replies[i] = post(blobs[i])

    t1 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t1
    bad = post(b"RIFF not a wave")
    if any(r is None or r[0] != 200 for r in replies) or bad[0] != 400:
        daemon.fail(f"replies {replies}, malformed WAV {bad}")
    texts = [ids_to_text(r[1]["tokens"]) for r in replies]
    for got, want in zip(texts, expected):
        print(f"serve {backend}: {'ok  ' if got == want else 'BAD '} "
              f"{got!r}")
    if texts != expected:
        daemon.fail("transcripts differ from artifacts/expected.json")
    print(f"serve {backend} (HTTP, int8 KV, 32 new tokens) [{card}]: "
          f"healthy {up:.1f} s after its start, 4 concurrent requests "
          f"{wall * 1e3:.1f} ms (the first batch's captures among them), a "
          f"malformed WAV answered 400")


def load_harness(card, backend: str):
    """The load harness (``benchmarks/serve_loadtest.py``) on ``backend``:
    ``LOAD_CLIENTS`` clients, ``LOAD_REQUESTS`` requests over the 4 WAVs,
    32 new tokens, int8 KV; every request must succeed."""
    log = os.path.join(ROOT, "build", "smoke", f"load_{backend}.log")
    stdout, wall = run_module(
        "whisper_trtllm_tpu_torch.benchmarks.serve_loadtest", 600,
        ["--checkpoint", ARTIFACT, "--wav-dir", EVAL_DIR, "--backend",
         backend, "--clients", str(LOAD_CLIENTS), "--requests",
         str(LOAD_REQUESTS), "--max-new-tokens", "32",
         "--kv-cache-dtype", "int8", "--daemon-log", log])
    rep = json.loads(stdout.strip().splitlines()[-1])
    if rep["requests_ok"] != LOAD_REQUESTS or rep["errors"]:
        with open(log) as f:
            fail(f"load {backend}: {rep}\n{f.read()[-4000:]}")
    lat = rep["latency_ms"]
    print(f"load {backend} ({LOAD_CLIENTS} clients, {LOAD_REQUESTS} "
          f"requests over the 4 WAVs, 32 new tokens, int8 KV, "
          f"{rep['num_slots']} slots) [{card}]: latency p50 {lat['p50']:.1f} "
          f"p90 {lat['p90']:.1f} p95 {lat['p95']:.1f} p99 {lat['p99']:.1f} "
          f"max {lat['max']:.1f} ms, {rep['throughput_req_s']:.2f} req/s, "
          f"{rep['audio_s_per_s']:.1f} audio-s/s of 30 s windows, "
          f"{rep['speech_s_per_s']:.1f} of speech; wall {rep['wall_s']:.2f} s "
          f"({wall:.1f} s with the daemon's start); connecting "
          f"{rep['connect_ms']['n']} times took p50 "
          f"{rep['connect_ms']['p50']:.2f} max {rep['connect_ms']['max']:.1f} "
          f"ms, {rep['connect_ms']['over_1s']} of them 1 s or more")
    print(f"load {backend} line: {json.dumps(rep)}")
    return rep


def serving(torch, np, card):
    """Phase 7. (a) The in-flight batcher in process on the artifact, 2
    lanes, in ``SERVE_CONFIGS``: the 4 utterances drained at once and
    staggered (2, one segment, 2 more), each giving the 4 texts, the
    staggered ids equal to the first; a double-buffered batcher's ids
    equal to the plain one's; in A, C and E the ids equal to the CPU
    batcher's and to the card's lockstep session's; launches exact over the
    steps the segments ran (K6 none), equal to the profiler's on one traced
    drain; one capture a batcher, then replays only. (b) ``cli.serve`` as
    a subprocess for each backend: the 4 WAVs at once give the 4 texts, a
    malformed WAV 400. (c) The load harness on the ifb and slots backends,
    and in process the host µs a segment, the segments a drain and the
    idle share over an untraced drain of ``LOAD_REQUESTS`` requests.
    Returns int8-auto's launches of its first drain."""
    from whisper_trtllm_tpu_torch.audio import read_wav
    from whisper_trtllm_tpu_torch.utils.checkpoint import load_checkpoint

    with open(os.path.join(ROOT, "artifacts", "expected.json")) as f:
        expected = json.load(f)["texts"]
    paths = [os.path.join(EVAL_DIR, f"utt{i:02d}.wav")
             for i in range(len(expected))]
    waves = [read_wav(p) for p in paths]
    params, cfg = load_checkpoint(ARTIFACT, device=DEVICE)
    params_cpu, _ = load_checkpoint(ARTIFACT, device="cpu")
    trees = {"int8": (params, params_cpu),
             "float": (float_tree(params), float_tree(params_cpu))}
    counts = None
    part_s = {}
    # (b)'s daemons start now, beside (a): their start-up overlaps it
    daemons = [Daemon(backend) for backend in ("slots", "ifb", "sched")]
    try:
        t0 = time.perf_counter()
        counts = _serve_in_process(torch, np, card, cfg, trees, waves,
                                   expected)
        part_s["batcher"] = time.perf_counter() - t0
        # (b) the HTTP daemon, each backend
        t0 = time.perf_counter()
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        for d in daemons:
            http_backend(card, d, blobs, expected)
        part_s["http"] = time.perf_counter() - t0
    finally:
        for d in daemons:
            d.stop()

    # (c) load numbers: the harness on ifb and slots, then the batcher as
    # cli.serve builds it, in process
    t0 = time.perf_counter()
    for backend in ("ifb", "slots"):
        load_harness(card, backend)
    part_s["load harness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_drain(torch, card, params, cfg, waves, expected)
    part_s["load drain"] = time.perf_counter() - t0
    print("serving seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in part_s.items()))
    return counts


def _serve_in_process(torch, np, card, cfg, trees, waves, expected):
    """(a) of ``serving``; returns int8-auto's launches of its first
    drain."""
    from whisper_trtllm_tpu_torch.audio import pad_or_trim
    from whisper_trtllm_tpu_torch.config import GenerationConfig, RuntimeConfig
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher
    from whisper_trtllm_tpu_torch.runtime.session import WhisperSession
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    counts = None
    for name, (weights, kv, layout, held) in SERVE_CONFIGS.items():
        tag = f"serve batcher {name} ({weights} weights, fp32, kv {kv}, " \
              f"cross {layout}, {SERVE_LANES} lanes)"
        gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype=kv,
                               cross_kv_layout=layout)
        tree, tree_cpu = trees[weights]

        def batcher(device=DEVICE, t=tree):
            gen_rt.reset_loop_counts()
            b = InflightBatcher(t, cfg, gen, num_lanes=SERVE_LANES,
                                segment_steps=SERVE_SEGMENT, device=device)
            if device == DEVICE and not (
                    gen_rt.LOOP.captures == 1
                    and gen_rt.LOOP.eager_steps == gen_rt.WARMUP_STEPS):
                fail(f"{tag}: building the batcher ran "
                     f"{gen_rt.LOOP.eager_steps} eager steps and "
                     f"{gen_rt.LOOP.captures} captures")
            return b

        b = batcher()
        reset_launch_counts()
        gen_rt.reset_loop_counts()
        rows = _drain(b, waves)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        steps = b.steps_run
        loop = gen_rt.LOOP
        if not (loop.replays == steps and loop.eager_steps == 0
                and loop.captures == 0):
            fail(f"{tag}: {loop.replays} replays, {loop.eager_steps} eager "
                 f"steps, {loop.captures} captures for {steps} steps")
        want = serve_launches(cfg, steps, len(waves))
        if launches != want:
            fail(f"{tag}: kernel launches {launches}, expected {want}")
        texts = [ids_to_text(r) for r in rows]
        for got, w in zip(texts, expected):
            print(f"{tag}: {'ok  ' if got == w else 'BAD '} {got!r}")
        if texts != expected:
            fail(f"{tag}: transcripts differ from artifacts/expected.json")
        segments = b._seg_idx
        staggered = _drain(b, waves, staggered=True)
        if not _same_rows(np, staggered, rows):
            fail(f"{tag}: the staggered submission's ids differ")
        busy, traced, counted = traced_run(torch, lambda: _drain(b, waves))
        if traced != counted:
            fail(f"{tag}: the counters {counted} differ from the profiler's "
                 f"launches {traced}")
        if gen_rt.LOOP.captures or gen_rt.LOOP.eager_steps:
            fail(f"{tag}: a drain did not only replay")
        del b
        os.environ["WHISPER_TPU_IFB_DOUBLE_BUFFER"] = "1"
        try:
            db = batcher()
            if not db._double_buffer:
                fail(f"{tag}: the double-buffer switch was not read")
            db_rows = _drain(db, waves)
        finally:
            del os.environ["WHISPER_TPU_IFB_DOUBLE_BUFFER"]
        del db
        if not _same_rows(np, db_rows, rows):
            fail(f"{tag}: the double-buffered ids differ from the plain "
                 f"ones")
        note = ""
        if held:
            cpu_rows = _drain(batcher("cpu", tree_cpu), waves)
            if not _same_rows(np, cpu_rows, rows):
                fail(f"{tag}: card ids differ from the CPU batcher's")
            tok, lens = WhisperSession(
                tree, cfg, gen, RuntimeConfig(compute_dtype="float32"),
                device=DEVICE).transcribe(
                    np.stack([pad_or_trim(w) for w in waves]))
            if not _same_rows(np, rows, [tok[i, :lens[i]]
                                         for i in range(len(waves))]):
                fail(f"{tag}: ids differ from the card's lockstep session's")
            note = ", equal to the CPU batcher's and the lockstep session's"
        print(f"{tag}: 4/4 texts, {steps} steps in {segments} segments "
              f"(replays only after 1 capture), launches {launches} as "
              f"expected and equal to the profiler's on a traced drain; "
              f"staggered and double-buffered ids equal{note} [{card}]")
        if name == "int8-auto":
            counts = launches
    return counts


def load_drain(torch, card, params, cfg, waves, expected):
    """(c) of ``serving`` in process: the batcher as ``cli.serve`` builds
    it, plain and double-buffered, over drains of ``LOAD_REQUESTS``
    requests (submit to drained), in turns (plain, double, double, plain,
    plain, double): each one's median wall of three, the segments and
    steps, the host µs a segment and a replay, and the idle share (a traced
    drain's device time over the median untraced one)."""
    from whisper_trtllm_tpu_torch.config import GenerationConfig
    from whisper_trtllm_tpu_torch.runtime.ifb import InflightBatcher
    from whisper_trtllm_tpu_torch.utils.vocab import ids_to_text

    gen = GenerationConfig(max_new_tokens=32, kv_cache_dtype="int8")
    load = [waves[i % len(waves)] for i in range(LOAD_REQUESTS)]
    want = [expected[i % len(expected)] for i in range(LOAD_REQUESTS)]
    runs = {}
    for double in (False, True):
        os.environ["WHISPER_TPU_IFB_DOUBLE_BUFFER"] = "1" if double else "0"
        try:
            b = InflightBatcher(params, cfg, gen, num_lanes=LOAD_LANES,
                                segment_steps=LOAD_SEGMENT, device=DEVICE)
        finally:
            del os.environ["WHISPER_TPU_IFB_DOUBLE_BUFFER"]
        if b._double_buffer != double:
            fail("serve load drain: the double-buffer switch was not read")
        host = {"segment": 0.0, "replay": 0.0}
        runs[double] = {"b": b, "host": host, "walls": [], "segs": []}
        dispatch, replay = b._dispatch_segment, b._graph.replay

        def timed_dispatch(dispatch=dispatch, host=host):
            t0 = time.perf_counter()
            out = dispatch()
            host["segment"] += time.perf_counter() - t0
            return out

        def timed_replay(replay=replay, host=host):
            t0 = time.perf_counter()
            replay()
            host["replay"] += time.perf_counter() - t0

        b._dispatch_segment, b._graph.replay = timed_dispatch, timed_replay
        _drain(b, load)  # warm
    for double in (False, True, True, False, False, True):
        r = runs[double]
        b, host = r["b"], r["host"]
        seg0, steps0 = b._seg_idx, b.steps_run
        host["segment"] = host["replay"] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = _drain(b, load)
        torch.cuda.synchronize()
        r["walls"].append((time.perf_counter() - t0) * 1e3)
        r["segs"].append((b._seg_idx - seg0, b.steps_run - steps0,
                          host["segment"], host["replay"]))
        if [ids_to_text(x) for x in rows] != want:
            fail(f"serve load drain (double buffer {double}): transcripts "
                 f"differ")
    for double, r in runs.items():
        b = r["b"]
        busy, traced, counted = traced_run(torch, lambda: _drain(b, load))
        if traced != counted:
            fail(f"serve load drain: the counters {counted} differ from the "
                 f"profiler's launches {traced}")
        r["busy"] = busy
    # where a plain drain's device time goes: one more traced drain, by
    # kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_trtllm_tpu_torch.utils.profile_transcribe import _device_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _drain(runs[False]["b"], load)
        torch.cuda.synchronize()
    by_kernel = sorted(((_device_us(e) / 1e3, e.key, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not e.key.startswith("Activity Buffer")),
                       reverse=True)
    print(f"serve load drain, a traced drain's device ms by kernel "
          f"[{card}]: " + "; ".join(f"{k[:48]} {ms:.2f} ({n})"
                                     for ms, k, n in by_kernel[:10]))
    for double, r in runs.items():
        walls = r["walls"]
        wall = statistics.median(walls)
        n_seg, n_steps, seg_s, rep_s = r["segs"][walls.index(wall)]
        busy = r["busy"]
        # the instance's wrappers hold bound methods of b and of its graph:
        # a reference cycle that would keep the weights (and so every
        # captured step that reads them) alive until a collection
        del r["b"]._dispatch_segment, r["b"]._graph.replay
        mode = "double-buffered" if double else "plain"
        print(f"serve batcher load drain ({mode}, int8 weights, fp32, "
              f"int8 KV T-minor, {LOAD_LANES} lanes, {LOAD_SEGMENT} steps a "
              f"segment, {LOAD_REQUESTS} requests, "
              f"submit to drained) [{card}]: {wall:.2f} ms median of 3 "
              f"({', '.join(f'{w:.2f}' for w in walls)} in turns), "
              f"{n_seg} segments, {n_steps} steps, host "
              f"{seg_s * 1e6 / n_seg:.2f} us a segment, of it the replays "
              f"{rep_s * 1e6 / n_seg:.2f} ({rep_s * 1e6 / n_steps:.2f} us a "
              f"replay) and the encodes queued behind it the most of the "
              f"rest, {LOAD_REQUESTS / (wall / 1e3):.2f} req/s; device busy "
              f"{busy:.2f} ms of a traced drain, idle share "
              f"{1 - busy / wall:.3f} of the median untraced drain")
    plain, dbl = (statistics.median(runs[d]["walls"]) for d in (False, True))
    print(f"serve batcher load drain, double-buffered over plain [{card}]: "
          f"{dbl / plain:.4f} of the median wall")


# --------------------------------------------------------------------------
# phase 2b: the causal-LM zoo's generation path
# --------------------------------------------------------------------------

ZOO_BATCH = 4
ZOO_NEW = 64
# a prompt of 800 positions: the prefill's causal attention is K1 (from
# 768 on, the JAX package's dispatch); 32: the plain formula
ZOO_LONG, ZOO_SHORT = 800, 32
ZOO_RAGGED = (800, 790, 780, 770)
ZOO_LLAMA_BATCH, ZOO_LLAMA_NEW = 2, 32
ZOO_BEAM_BATCH, ZOO_BEAM_K, ZOO_BEAM_NEW = 2, 4, 32
ZOO_LLAMA_BEAM_NEW = 16
# a step whose CPU logits' two largest lie closer than this share of
# max |logit| may go either way under fp32 sums in another order: it ends
# the token comparison, and is printed with its gap
ZOO_GAP = 1e-4
ZOO_BEAM_SCORE_TOLERANCE = 1e-3
ZOO_PTUNING = (2, 8)  # tasks, virtual tokens a task
ZOO_RULES = dict(repetition_penalty=1.3)
ZOO_SAMPLED = dict(temperature=0.8, top_k=40)
ZOO_KERNELS = ("flash_fwd", "decode_attn", "layer_norm")
ZOO_TRACED_NEW = 8
# gptj_6b's and gptneox_20b's widths at 2 layers: lockstep at batch 2 from
# 800, ragged at 800/790, beams K 2 at batch 2 from 32 (16 new)
ZOO_WIDE = ("gptj_6b", "gptneox_20b")
ZOO_WIDE_BATCH, ZOO_WIDE_NEW = 2, 32
ZOO_WIDE_RAGGED = (800, 790)
ZOO_WIDE_BEAM_K, ZOO_WIDE_BEAM_NEW = 2, 16
# bloom_560m at full width and depth (24 layers): the gpt_350m runs'
# shapes (lockstep at batch 4 from 800, 64 new; ragged 800..770; beams K 4
# at batch 2 from 32); chatglm_6b's widths at 2 layers: the wide runs'
# (batch 2 from 800, 32 new, the [gMASK] at 798; ragged 800/790; beams K 2
# at batch 2 from 32, 16 new). Neither prefill runs K1 (masked attention
# in Bloom's, the prefix-LM's plain einsums in GLM's)
ZOO_ALIBI = ("bloom_560m", "chatglm_6b")


def zoo_weights() -> dict:
    """The zoo phase's trees on the host, ``init_params(seed=0)``:
    gpt_350m at full width and depth, opt_350m's widths cut to 2 layers
    (depth only: the time limit's cut when Bloom and ChatGLM came),
    llama_7b's widths cut
    to 2 layers (depth only), with 32 and with 8 key/value heads, and
    gptj_6b's and gptneox_20b's widths cut to 2 layers (0.82 G and 1.53 G
    parameters), bloom_560m whole (0.56 G) and chatglm_6b's widths at 2
    layers (1.47 G, 1.07 G of them its two vocab tables). Each model draws from its own generator in a thread of
    its own (numpy releases the GIL while it fills an array): drawn one
    after another, the 4.3 G values outlasted the kernels phase by ~40 s
    (NVIDIA H100 80GB HBM3 host, 700 W). Phase 2c's trees too: bert_large
    whole (0.34 G) and the UNet at SD-1.x's widths and depth (0.86 G)."""
    import dataclasses

    from whisper_trtllm_tpu_torch.benchmarks.allowed_configs import (
        build_model,
    )

    def draw(name):
        if name == "bloom_560m":  # no registry entry, as in the JAX package
            return draw_bloom(name)
        if name == "unet":
            from whisper_trtllm_tpu_torch.models import unet

            cfg = unet.UNetConfig()
            return {name: (cfg, unet.init_params(cfg, seed=0, device="cpu"))}
        _, cfg, init, _, _ = build_model(name)
        if name not in ("gpt_350m", "bert_large"):
            cfg = dataclasses.replace(cfg, n_layer=2)
        trees = {name: (cfg, init(cfg, seed=0, device="cpu"))}
        if name == "llama_7b":
            gqa = dataclasses.replace(cfg, n_kv_head=8)
            trees["llama_7b gqa"] = (gqa, init(gqa, seed=0, device="cpu"))
        return trees

    def draw_bloom(name):
        from whisper_trtllm_tpu_torch.models import bloom

        cfg = bloom.BloomConfig()
        return {name: (cfg, bloom.init_params(cfg, seed=0, device="cpu"))}

    names = ("gpt_350m", "opt_350m", "llama_7b") + ZOO_WIDE + ZOO_ALIBI + (
        "bert_large", "unet")
    out = {}
    with ThreadPoolExecutor(len(names)) as pool:
        for trees in pool.map(draw, names):
            out.update(trees)
    return out


def zoo_launches(fam: str, cfg, long: bool, steps: int) -> dict:
    """A generate call's launches: a prefill (K1 a layer when long, but
    never in Bloom's masked or ChatGLM's prefix-LM prefill; K5 for GPT's,
    OPT's, GPT-NeoX's and ChatGLM's 2L + 1 LayerNorms, GPT-J's L + 1,
    Bloom's 2L + 2 with its embedding LayerNorm) and ``steps`` steps (K2 a
    layer, K5 as many again; LLaMA's RMSNorm has no kernel)."""
    n = cfg.n_layer
    norms = {"llama": 0, "gptj": n + 1, "bloom": 2 * n + 2}.get(fam,
                                                               2 * n + 1)
    flash = n if long and fam not in ("bloom", "chatglm6b") else 0
    return {"flash_fwd": flash, "decode_attn": n * steps,
            "layer_norm": norms * (1 + steps)}


def zoo_run(torch, tag: str, fam: str, cfg, long: bool, fn, repeat=False):
    """One generate call from zero counts, its launches held to
    ``zoo_launches`` over the steps the loop ran, each other kernel at 0,
    at most one capture (a warm-up step before it) and the rest replays;
    ``repeat``: a call whose entry is cached, replays only. Returns (the
    output, the steps, the ms)."""
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt

    torch.cuda.synchronize()
    reset_launch_counts()
    gen_rt.reset_loop_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    loop = gen_rt.LOOP
    steps = loop.steps
    want = {k: 0 for k in KERNELS}
    want.update(zoo_launches(fam, cfg, long, steps))
    got = {k: f.launches for k, f in KERNELS.items()}
    if got != want:
        fail(f"zoo {tag}: launches {got}, expected {want} over {steps} steps")
    if loop.captures > (0 if repeat else 1) or \
            loop.eager_steps != gen_rt.WARMUP_STEPS * loop.captures or \
            loop.replays != steps - loop.eager_steps:
        fail(f"zoo {tag}: {loop.captures} captures, {loop.eager_steps} eager "
             f"steps, {loop.replays} replays over {steps} steps")
    return out, steps, ms


def zoo_prefill_ms(torch, mod, params, cfg, prompt, kv_heads: int,
                   *positions) -> float:
    """The median ms of the model's prefill alone (5 calls, fresh caches);
    ``positions``: ChatGLM's position ids and prefix length, which its
    prefill takes before the caches."""
    b, p = prompt.shape
    shape = (cfg.n_layer, b, kv_heads, p, cfg.head_dim)
    dtype = next(t for t in params.values()
                 if isinstance(t, torch.Tensor)).dtype
    ck = torch.zeros(shape, dtype=dtype, device=DEVICE)
    cv = torch.zeros_like(ck)
    with torch.inference_mode():
        _, ms, _, _ = timed(torch, lambda: mod._prefill(
            params, cfg, prompt, *positions, ck, cv))
    return ms


def zoo_tokens_match(torch, tag, logits, seq, prompt_len, eos, process=None,
                     stop=None) -> int:
    """Lane 0 of a card run against the CPU: ``logits`` (S, V) the port's
    teacher-forced ``forward`` on the CPU over the card's sequence ``seq``
    (S,); at each position p from ``prompt_len - 1`` the card's token
    ``seq[p + 1]`` must be the argmax of the CPU's logits (through
    ``process(logits (1, V), seq, p)`` for a rule-bound run), until the
    lane's EOS or stop word. A step whose two largest lie within
    ``ZOO_GAP`` of max |logit| ends the comparison (printed). Returns the
    steps compared."""
    from whisper_trtllm_tpu_torch.runtime import sampling

    seq_t = torch.as_tensor(seq, dtype=torch.int32)[None]
    n = 0
    for p in range(prompt_len - 1, len(seq) - 1):
        row = logits[p][None].float()
        if process is not None:
            row = process(row, seq_t, p)
        top2 = torch.topk(row[0], 2).values
        gap = (top2[0] - top2[1]).item()
        want, got = int(torch.argmax(row[0])), int(seq[p + 1])
        if want != got:
            if gap < ZOO_GAP * row[0].abs().max().item():
                print(f"zoo {tag}: step {n} (position {p + 1}) is a near "
                      f"tie on the CPU (top-two gap {gap:.3e}), card "
                      f"{got}, CPU {want}: the comparison ends there")
                return n
            fail(f"zoo {tag}: position {p + 1}: card token {got}, CPU "
                 f"argmax {want} (top-two gap {gap:.3e})")
        n += 1
        if got == eos or (stop is not None and bool(
                sampling.match_stop_words(seq_t, p + 1, stop)[0])):
            break
    return n


def zoo_bad_word_absent(np, out, prompt_len, word) -> None:
    gen = np.asarray(out)[:, prompt_len:]
    if (gen == word).any():
        fail(f"zoo rules: the bad word {word} was generated")


def zoo_beams_match(torch, tag, card_out, cpu_out) -> int:
    """The card's beams against the CPU's: every score (best first) within
    ``ZOO_BEAM_SCORE_TOLERANCE`` of the CPU's at its rank; tokens equal up
    to the first rank of a lane where they part (printed). Returns the
    hypotheses compared token for token."""
    toks, scores, lens = (x.cpu() for x in card_out)
    ctoks, cscores, clens = cpu_out
    diff = (scores - cscores).abs().max().item()
    if not math.isfinite(diff) or diff > ZOO_BEAM_SCORE_TOLERANCE:
        fail(f"zoo {tag}: beam scores {scores.tolist()} against the CPU's "
             f"{cscores.tolist()} (max diff {diff:.3e})")
    same = 0
    for b in range(toks.shape[0]):
        for k in range(toks.shape[1]):
            if not (torch.equal(toks[b, k], ctoks[b, k])
                    and int(lens[b, k]) == int(clens[b, k])):
                print(f"zoo {tag}: lane {b} parts from the CPU at rank {k} "
                      f"(scores {scores[b].tolist()} / "
                      f"{cscores[b].tolist()})")
                break
            same += 1
    print(f"zoo {tag}: beam scores within {diff:.3e} of the CPU's, "
          f"{same} of {toks.shape[0] * toks.shape[1]} hypotheses "
          f"token-equal")
    return same


def zoo_ragged_lanes(torch, np, tag, mod, params, cfg, prompt, out_r,
                     new: int, cpu_forward, long_lens) -> None:
    """Each ragged lane equals its own lockstep run at batch 1 (a near tie
    on the CPU, where they part, is printed and ends that lane)."""
    for b, n in enumerate(long_lens):
        lane = zoo_run(torch, f"{tag} lane {b} lockstep", mod.__name__.split(
            ".")[-2], cfg, n >= 768, lambda: mod.generate(
                params, cfg, prompt[b:b + 1, :n], new))[0].cpu().numpy()[0]
        got = np.asarray(out_r[b, :n + new])
        if np.array_equal(got, lane):
            continue
        at = int(np.nonzero(got != lane)[0][0])
        logits = cpu_forward(lane[None, :at], n)[0]
        top2 = torch.topk(logits[at - 1].float(), 2).values
        gap = (top2[0] - top2[1]).item()
        if gap >= ZOO_GAP * logits[at - 1].abs().max().item():
            fail(f"zoo {tag}: lane {b} parts from its lockstep run at "
                 f"position {at} (CPU top-two gap {gap:.3e})")
        print(f"zoo {tag}: lane {b} parts from its lockstep run at a near "
              f"tie, position {at} (CPU top-two gap {gap:.3e})")


def zoo(torch, np, card, trees) -> dict:
    """The phase of the module docstring; returns the launches of
    gpt_350m's long lockstep call (the kernel table's "zoo" column) under
    "", and GPT-J's and GPT-NeoX's under "_gptj" and "_gptneox"."""
    from whisper_trtllm_tpu_torch.models import (
        bloom,
        chatglm6b,
        gpt,
        gptj,
        gptneox,
        llama,
        opt,
    )
    from whisper_trtllm_tpu_torch.models.bloom import model as bloom_model
    from whisper_trtllm_tpu_torch.models.chatglm6b import model as glm_model
    from whisper_trtllm_tpu_torch.models.gpt import model as gpt_model
    from whisper_trtllm_tpu_torch.models.gptj import model as gptj_model
    from whisper_trtllm_tpu_torch.models.gptneox import model as gptneox_model
    from whisper_trtllm_tpu_torch.models.llama import model as llama_model
    from whisper_trtllm_tpu_torch.models.opt import model as opt_model
    from whisper_trtllm_tpu_torch.runtime import causal_lm
    from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

    # the CPU's checks run beside the card's calls, in a thread started
    # after the traced call: traces that followed one taken while another
    # thread ran torch ops lost kernel records. Those that run a decode
    # loop (the CPU's beams) wait until the card's calls are done, whose
    # loop counts they would join
    cpu = None
    jobs, after = [], []
    rng = np.random.default_rng(SEED)
    counts = {}

    def cpu_check(fn):
        nonlocal cpu
        cpu = cpu or ThreadPoolExecutor(1)
        jobs.append(cpu.submit(fn))

    # ---- gpt_350m, fp32 ----------------------------------------------------
    cfg, host = trees["gpt_350m"]
    params = params_from_numpy(host, DEVICE)
    v = cfg.vocab_size
    long_p = rng.integers(3, v, (ZOO_BATCH, ZOO_LONG)).astype(np.int32)
    short_p = rng.integers(3, v, (ZOO_BATCH, ZOO_SHORT)).astype(np.int32)
    prefill = {"long": zoo_prefill_ms(
        torch, gpt_model, params, cfg, torch.from_numpy(long_p).to(DEVICE),
        cfg.n_head), "short": zoo_prefill_ms(
        torch, gpt_model, params, cfg, torch.from_numpy(short_p).to(DEVICE),
        cfg.n_head)}

    def report(tag, fam, cfg_, long, fn, first, steps, ms, pre=None):
        """The first call's ms and its capture's; then the call again,
        replays only, its outputs the first call's, and its ms a step: the
        call's less the prefill's, over its steps."""
        from whisper_trtllm_tpu_torch.runtime import generation as gen_rt

        cap = gen_rt.LOOP.capture_ms
        out, _, ms2 = zoo_run(torch, f"{tag} repeat", fam, cfg_, long, fn,
                              repeat=True)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        first if isinstance(first, tuple) else (first,)):
            if not torch.equal(a, b):
                fail(f"zoo {tag}: a repeat call gave other outputs")
        per = "" if pre is None else (
            f", prefill {pre:.3f} ms, {(ms2 - pre) / max(steps, 1):.4f} ms a "
            f"step")
        print(f"zoo {tag}: {steps} steps; first call {ms:.2f} ms (capture "
              f"{cap:.2f}), repeat {ms2:.2f} ms{per} [{card}]")

    def cpu_forward(mod, host_tree, cfg_, **kw):
        """The CPU's teacher-forced logits of a sequence (its prompt's
        length only read by ChatGLM's, whose positions depend on it)."""
        def fwd(seq, prompt_len=None):
            with torch.inference_mode():
                if mod is chatglm6b:
                    ids = chatglm6b.build_position_ids(
                        seq.shape[1], prompt_len - 2, prompt_len)
                    return mod.forward(host_tree, cfg_, seq, np.repeat(
                        ids[None], seq.shape[0], 0), prompt_len)
                return mod.forward(host_tree, cfg_, seq, **kw)
        return fwd

    def greedy_vs_cpu(tag, mod, host_tree, cfg_, out, prompt_len,
                      check=None, **kw):
        seq = out[0].cpu().numpy()

        def job():
            logits = cpu_forward(mod, host_tree, cfg_, **kw)(
                seq[None], prompt_len)[0]
            n = zoo_tokens_match(torch, tag, logits, seq, prompt_len,
                                 cfg_.eos_token_id)
            print(f"zoo {tag}: lane 0 equals the CPU's argmax over {n} "
                  f"steps")
        (check or cpu_check)(job)

    def traced_call(tag, fam, cfg_, call):
        """The profiler's count over one call whose entry is cached
        (replays only), against the counters: the call once untraced
        (its capture), then traced."""
        first, _, _ = zoo_run(torch, f"{tag} traced", fam, cfg_, True, call)
        box = {}

        def again():
            box["out"], box["steps"], _ = zoo_run(
                torch, f"{tag} traced repeat", fam, cfg_, True, call,
                repeat=True)
        _, traced, counted = traced_run(torch, again, ENGINE_SYMBOLS)
        if not torch.equal(box["out"], first):
            fail(f"zoo {tag} traced: a repeat call gave other tokens")
        if {k: traced[k] for k in ZOO_KERNELS} != {k: counted[k]
                                                   for k in ZOO_KERNELS}:
            fail(f"zoo {tag} traced: profiler {traced} != counters "
                 f"{counted}")
        print(f"zoo {tag} traced ({ZOO_TRACED_NEW} new tokens, "
              f"{box['steps']} steps, replays only): launches {counted} "
              f"equal the profiler's")

    # ---- gptj_6b's and gptneox_20b's widths, 2 layers, fp32 ----------------
    # first, while no CPU check runs: their checks wait in `early` until
    # the CPU's thread starts after gpt's traced call
    early = []
    wide_counts = {}
    for name, fam, mod, mod_model in (
            ("gptj_6b", "gptj", gptj, gptj_model),
            ("gptneox_20b", "gptneox", gptneox, gptneox_model)):
        wcfg, whost = trees[name]
        wparams = params_from_numpy(whost, DEVICE)
        wp = long_p[:ZOO_WIDE_BATCH] % wcfg.vocab_size
        tag = f"{name} (2 layers, {wcfg.n_head} heads of {wcfg.head_dim})"
        out_w, steps, ms = zoo_run(
            torch, f"{name} long", fam, wcfg, True,
            lambda: mod.generate(wparams, wcfg, wp, ZOO_WIDE_NEW))
        wide_counts["_" + fam] = zoo_launches(fam, wcfg, True, steps)
        pre = zoo_prefill_ms(torch, mod_model, wparams, wcfg,
                             torch.from_numpy(wp).to(DEVICE), wcfg.n_head)
        report(f"{tag} lockstep B {ZOO_WIDE_BATCH} prompt {ZOO_LONG}", fam,
               wcfg, True,
               lambda: mod.generate(wparams, wcfg, wp, ZOO_WIDE_NEW), out_w,
               steps, ms, pre)
        traced_call(name, fam, wcfg,
                    lambda: mod.generate(wparams, wcfg, wp, ZOO_TRACED_NEW))
        greedy_vs_cpu(f"{name} long", mod, whost, wcfg, out_w, ZOO_LONG,
                      early.append)
        out_r, steps, ms = zoo_run(
            torch, f"{name} ragged", fam, wcfg, True,
            lambda: mod.generate_ragged(wparams, wcfg, wp,
                                        list(ZOO_WIDE_RAGGED), ZOO_WIDE_NEW))
        report(f"{tag} ragged {list(ZOO_WIDE_RAGGED)}", fam, wcfg, True,
               lambda: mod.generate_ragged(wparams, wcfg, wp,
                                           list(ZOO_WIDE_RAGGED),
                                           ZOO_WIDE_NEW), out_r, steps, ms,
               pre)
        zoo_ragged_lanes(torch, np, f"{name} ragged", mod_model, wparams,
                         wcfg, wp, out_r.cpu().numpy(), ZOO_WIDE_NEW,
                         cpu_forward(mod, whost, wcfg), ZOO_WIDE_RAGGED)
        bpw = short_p[:ZOO_WIDE_BATCH] % wcfg.vocab_size
        out_wb, steps, ms = zoo_run(
            torch, f"{name} beams", fam, wcfg, False,
            lambda: mod.generate_beam(wparams, wcfg, bpw, ZOO_WIDE_BEAM_NEW,
                                      ZOO_WIDE_BEAM_K))
        report(f"{tag} beams K {ZOO_WIDE_BEAM_K} B {ZOO_WIDE_BATCH}", fam,
               wcfg, False, lambda: mod.generate_beam(
                   wparams, wcfg, bpw, ZOO_WIDE_BEAM_NEW, ZOO_WIDE_BEAM_K),
               out_wb, steps, ms)
        out_wb = tuple(x.cpu() for x in out_wb)

        def wbeams_job(name=name, mod=mod, whost=whost, wcfg=wcfg, bpw=bpw,
                       out_wb=out_wb):
            zoo_beams_match(torch, f"{name} beams", out_wb, mod.generate_beam(
                whost, wcfg, bpw, ZOO_WIDE_BEAM_NEW, ZOO_WIDE_BEAM_K,
                device="cpu"))
        after.append(wbeams_job)
        del wparams

    # ---- bloom_560m whole and chatglm_6b's widths at 2 layers, fp32 --------
    # also before any CPU check runs (their traced calls too)
    alibi_counts = {}
    for name, fam, mod, mod_model, batch, new, ragged, beam_k, beam_new in (
            ("bloom_560m", "bloom", bloom, bloom_model, ZOO_BATCH, ZOO_NEW,
             ZOO_RAGGED, ZOO_BEAM_K, ZOO_BEAM_NEW),
            ("chatglm_6b", "chatglm6b", chatglm6b, glm_model, ZOO_WIDE_BATCH,
             ZOO_WIDE_NEW, ZOO_WIDE_RAGGED, ZOO_WIDE_BEAM_K,
             ZOO_WIDE_BEAM_NEW)):
        acfg, ahost = trees[name]
        aparams = params_from_numpy(ahost, DEVICE)
        ap = long_p[:batch] % acfg.vocab_size
        tag = (f"{name} ({acfg.n_layer} layers, {acfg.n_head} heads of "
               f"{acfg.head_dim})")
        out_a, steps, ms = zoo_run(
            torch, f"{name} long", fam, acfg, True,
            lambda: mod.generate(aparams, acfg, ap, new))
        alibi_counts["_" + fam] = zoo_launches(fam, acfg, True, steps)
        apt = torch.from_numpy(ap).to(DEVICE)
        positions = () if fam == "bloom" else (torch.from_numpy(
            mod.build_position_ids(ZOO_LONG, ZOO_LONG - 2, ZOO_LONG)).to(
            DEVICE)[None].expand(batch, 2, ZOO_LONG), ZOO_LONG)
        pre = zoo_prefill_ms(torch, mod_model, aparams, acfg, apt,
                             acfg.n_head, *positions)
        report(f"{tag} lockstep B {batch} prompt {ZOO_LONG}", fam, acfg, True,
               lambda: mod.generate(aparams, acfg, ap, new), out_a, steps, ms,
               pre)
        traced_call(name, fam, acfg,
                    lambda: mod.generate(aparams, acfg, ap, ZOO_TRACED_NEW))
        greedy_vs_cpu(f"{name} long", mod, ahost, acfg, out_a, ZOO_LONG,
                      early.append)
        if fam == "bloom":
            # bf16: printed, not gated
            p16 = params_from_numpy(ahost, DEVICE, torch.bfloat16)
            out16, steps, ms = zoo_run(
                torch, f"{name} bf16", fam, acfg, True,
                lambda: mod.generate(p16, acfg, ap, new))
            same = (out16.cpu()[:, ZOO_LONG:] == out_a.cpu()[:, ZOO_LONG:]
                    ).float().mean().item()
            report(f"{tag} bf16 lockstep B {batch} prompt {ZOO_LONG}", fam,
                   acfg, True, lambda: mod.generate(p16, acfg, ap, new), out16,
                   steps, ms)
            print(f"zoo {name} bf16: {same:.4f} of its new tokens equal the "
                  f"fp32 run's (not gated)")
            del p16
        out_r, steps, ms = zoo_run(
            torch, f"{name} ragged", fam, acfg, True,
            lambda: mod.generate_ragged(aparams, acfg, ap, list(ragged), new))
        report(f"{tag} ragged {list(ragged)}", fam, acfg, True,
               lambda: mod.generate_ragged(aparams, acfg, ap, list(ragged),
                                           new), out_r, steps, ms)
        zoo_ragged_lanes(torch, np, f"{name} ragged", mod_model, aparams, acfg,
                         ap, out_r.cpu().numpy(), new,
                         cpu_forward(mod, ahost, acfg), ragged)
        draws = []
        for seed in (1, 1):
            out_s, steps, ms = zoo_run(
                torch, f"{name} sampled seed {seed}", fam, acfg, True,
                lambda: mod.generate(aparams, acfg, ap, new, seed=seed,
                                     **ZOO_SAMPLED), repeat=bool(draws))
            draws.append(out_s.cpu())
        if not torch.equal(draws[0], draws[1]):
            fail(f"zoo {name} sampled: seed 1 did not repeat its draw")
        print(f"zoo {name} sampled (temperature 0.8, top-k 40): seed 1 twice "
              f"equal, the second call replays only; {steps} steps "
              f"{ms:.2f} ms")
        bpa = short_p[:ZOO_BEAM_BATCH] % acfg.vocab_size
        out_ab, steps, ms = zoo_run(
            torch, f"{name} beams", fam, acfg, False,
            lambda: mod.generate_beam(aparams, acfg, bpa, beam_new, beam_k))
        report(f"{tag} beams K {beam_k} B {ZOO_BEAM_BATCH}", fam, acfg, False,
               lambda: mod.generate_beam(aparams, acfg, bpa, beam_new, beam_k),
               out_ab, steps, ms)
        out_ab = tuple(x.cpu() for x in out_ab)

        def abeams_job(name=name, mod=mod, ahost=ahost, acfg=acfg, bpa=bpa,
                       out_ab=out_ab, beam_new=beam_new, beam_k=beam_k):
            zoo_beams_match(torch, f"{name} beams", out_ab, mod.generate_beam(
                ahost, acfg, bpa, beam_new, beam_k, device="cpu"))
        after.append(abeams_job)
        del aparams

    out_long, steps, ms = zoo_run(
        torch, "gpt long", "gpt", cfg, True,
        lambda: gpt.generate(params, cfg, long_p, ZOO_NEW))
    counts = zoo_launches("gpt", cfg, True, steps)
    report(f"gpt_350m lockstep B {ZOO_BATCH} prompt {ZOO_LONG}", "gpt", cfg,
           True, lambda: gpt.generate(params, cfg, long_p, ZOO_NEW), out_long,
           steps, ms, prefill["long"])
    # the profiler's count over one traced call: the long prompt's
    # prefill and a few replayed steps
    traced_call("gpt", "gpt", cfg,
                lambda: gpt.generate(params, cfg, long_p, ZOO_TRACED_NEW))
    for job in early:
        cpu_check(job)
    greedy_vs_cpu("gpt long", gpt, host, cfg, out_long, ZOO_LONG)

    out_short, steps, ms = zoo_run(
        torch, "gpt short", "gpt", cfg, False,
        lambda: gpt.generate(params, cfg, short_p, ZOO_NEW))
    report(f"gpt_350m lockstep B {ZOO_BATCH} prompt {ZOO_SHORT}", "gpt", cfg,
           False, lambda: gpt.generate(params, cfg, short_p, ZOO_NEW),
           out_short, steps, ms, prefill["short"])
    greedy_vs_cpu("gpt short", gpt, host, cfg, out_short, ZOO_SHORT)

    out_r, steps, ms = zoo_run(
        torch, "gpt ragged", "gpt", cfg, True,
        lambda: gpt.generate_ragged(params, cfg, long_p, list(ZOO_RAGGED),
                                    ZOO_NEW))
    report(f"gpt_350m ragged {list(ZOO_RAGGED)}", "gpt", cfg, True,
           lambda: gpt.generate_ragged(params, cfg, long_p, list(ZOO_RAGGED),
                                       ZOO_NEW), out_r, steps, ms,
           prefill["long"])
    zoo_ragged_lanes(torch, np, "gpt ragged", gpt_model, params, cfg, long_p,
                     out_r.cpu().numpy(), ZOO_NEW,
                     cpu_forward(gpt, host, cfg), ZOO_RAGGED)

    # repetition penalty, a bad word (lane 0's first greedy token) and a
    # stop word (its tokens 5 and 6 of the greedy run)
    g0 = out_short[0].cpu().numpy()[ZOO_SHORT:]
    bad, stop = [[int(g0[0])]], [[int(g0[5]), int(g0[6])]]
    sc = causal_lm.make_sampling_cfg(bad_words=bad, stop_words=stop,
                                     **ZOO_RULES)
    out_rules, steps, ms = zoo_run(
        torch, "gpt rules", "gpt", cfg, False,
        lambda: gpt.generate(params, cfg, short_p, ZOO_NEW, sampling_cfg=sc))
    report("gpt_350m penalty, bad and stop words", "gpt", cfg, False,
           lambda: gpt.generate(params, cfg, short_p, ZOO_NEW,
                                sampling_cfg=sc), out_rules, steps, ms,
           prefill["short"])
    zoo_bad_word_absent(np, out_rules.cpu(), ZOO_SHORT, bad[0][0])
    words = causal_lm.device_words(sc, "cpu")

    def rules(row, seq_t, p, eos=cfg.eos_token_id):
        return causal_lm.process_logits(sc, row, seq_t, p,
                                        p + 1 - ZOO_SHORT, eos, words)

    seq_rules = out_rules[0].cpu().numpy()

    # (the CPU's jobs run later: each binds the trees it reads now)
    def rules_job(host=host, cfg=cfg):
        logits = gpt.forward(host, cfg, seq_rules[None])[0]
        n = zoo_tokens_match(torch, "gpt rules", logits, seq_rules,
                             ZOO_SHORT, cfg.eos_token_id, rules, words.stop)
        print(f"zoo gpt rules: lane 0 equals the CPU's processed argmax over "
              f"{n} steps")
    cpu_check(rules_job)

    draws = []
    for seed in (1, 1, 2):
        out_s, steps, ms = zoo_run(
            torch, f"gpt sampled seed {seed}", "gpt", cfg, False,
            lambda: gpt.generate(params, cfg, short_p, ZOO_NEW, seed=seed,
                                 **ZOO_SAMPLED), repeat=len(draws) == 1)
        draws.append(out_s.cpu())
    if not torch.equal(draws[0], draws[1]) or torch.equal(draws[0], draws[2]):
        fail("zoo gpt sampled: a seed must repeat its draw and another seed "
             "draw otherwise")
    print(f"zoo gpt sampled (temperature 0.8, top-k 40): seed 1 twice "
          f"equal, seed 2 differs; {steps} steps {ms:.2f} ms")

    tasks, virt = ZOO_PTUNING
    table = (rng.standard_normal((tasks, virt, cfg.d_model)) * 0.02).astype(
        np.float32)
    ids = short_p.copy()
    ids[:, :virt] = v + np.arange(virt)
    task_ids = np.arange(ZOO_BATCH, dtype=np.int32) % tasks
    out_pt, steps, ms = zoo_run(
        torch, "gpt p-tuning", "gpt", cfg, False,
        lambda: gpt.generate_ptuning(params, cfg, ids, table, task_ids,
                                     ZOO_NEW))
    report("gpt_350m p-tuning", "gpt", cfg, False,
           lambda: gpt.generate_ptuning(params, cfg, ids, table, task_ids,
                                        ZOO_NEW), out_pt, steps, ms,
           prefill["short"])
    greedy_vs_cpu("gpt p-tuning", gpt, host, cfg, out_pt, ZOO_SHORT,
                  ptuning=(torch.from_numpy(table),
                           torch.from_numpy(task_ids[:1]).long()))

    bp = short_p[:ZOO_BEAM_BATCH]
    out_b, steps, ms = zoo_run(
        torch, "gpt beams", "gpt", cfg, False,
        lambda: gpt.generate_beam(params, cfg, bp, ZOO_BEAM_NEW, ZOO_BEAM_K))
    report(f"gpt_350m beams K {ZOO_BEAM_K} B {ZOO_BEAM_BATCH}", "gpt", cfg,
           False, lambda: gpt.generate_beam(params, cfg, bp, ZOO_BEAM_NEW,
                                            ZOO_BEAM_K), out_b, steps, ms)
    out_b = tuple(x.cpu() for x in out_b)

    def beams_job(host=host, cfg=cfg):
        zoo_beams_match(torch, "gpt beams", out_b, gpt.generate_beam(
            host, cfg, bp, ZOO_BEAM_NEW, ZOO_BEAM_K, device="cpu"))
    after.append(beams_job)

    # bf16: printed, not gated
    p16 = params_from_numpy(host, DEVICE, torch.bfloat16)
    out16, steps, ms = zoo_run(
        torch, "gpt bf16", "gpt", cfg, True,
        lambda: gpt.generate(p16, cfg, long_p, ZOO_NEW))
    same = (out16.cpu()[:, ZOO_LONG:] == out_long.cpu()[:, ZOO_LONG:]).float(
    ).mean().item()
    report(f"gpt_350m bf16 lockstep B {ZOO_BATCH} prompt {ZOO_LONG}", "gpt",
           cfg, True, lambda: gpt.generate(p16, cfg, long_p, ZOO_NEW), out16,
           steps, ms, zoo_prefill_ms(torch, gpt_model, p16, cfg,
                                     torch.from_numpy(long_p).to(DEVICE),
                                     cfg.n_head))
    print(f"zoo gpt bf16: {same:.4f} of its new tokens equal the fp32 "
          f"run's (not gated)")
    del p16, params

    # ---- opt_350m, fp32 ----------------------------------------------------
    cfg, host = trees["opt_350m"]
    params = params_from_numpy(host, DEVICE)
    op = long_p % cfg.vocab_size
    out_o, steps, ms = zoo_run(
        torch, "opt long", "opt", cfg, True,
        lambda: opt.generate(params, cfg, op, ZOO_NEW))
    pre = zoo_prefill_ms(torch, opt_model, params, cfg,
                         torch.from_numpy(op).to(DEVICE), cfg.n_head)
    report(f"opt_350m (2 layers) lockstep B {ZOO_BATCH} prompt {ZOO_LONG}",
           "opt", cfg,
           True, lambda: opt.generate(params, cfg, op, ZOO_NEW), out_o, steps,
           ms, pre)
    greedy_vs_cpu("opt long", opt, host, cfg, out_o, ZOO_LONG)
    out_r, steps, ms = zoo_run(
        torch, "opt ragged", "opt", cfg, True,
        lambda: opt.generate_ragged(params, cfg, op, list(ZOO_RAGGED),
                                    ZOO_NEW))
    report(f"opt_350m (2 layers) ragged {list(ZOO_RAGGED)}", "opt", cfg, True,
           lambda: opt.generate_ragged(params, cfg, op, list(ZOO_RAGGED),
                                       ZOO_NEW), out_r, steps, ms, pre)
    zoo_ragged_lanes(torch, np, "opt ragged", opt_model, params, cfg, op,
                     out_r.cpu().numpy(), ZOO_NEW,
                     cpu_forward(opt, host, cfg), ZOO_RAGGED)
    del params

    # ---- llama_7b widths, 2 layers, fp32 -----------------------------------
    for name in ("llama_7b", "llama_7b gqa"):
        cfg, host = trees[name]
        params = params_from_numpy(host, DEVICE)
        lp = long_p[:ZOO_LLAMA_BATCH] % cfg.vocab_size
        out_l, steps, ms = zoo_run(
            torch, f"{name} long", "llama", cfg, True,
            lambda: llama.generate(params, cfg, lp, ZOO_LLAMA_NEW))
        report(f"{name} (2 layers, {cfg.n_kv_head} kv heads) lockstep B "
               f"{ZOO_LLAMA_BATCH} prompt {ZOO_LONG}", "llama", cfg, True,
               lambda: llama.generate(params, cfg, lp, ZOO_LLAMA_NEW), out_l,
               steps, ms, zoo_prefill_ms(torch, llama_model, params, cfg,
                                         torch.from_numpy(lp).to(DEVICE),
                                         cfg.n_kv_head))
        greedy_vs_cpu(f"{name} long", llama, host, cfg, out_l, ZOO_LONG)
        if name == "llama_7b":
            bpl = short_p[:ZOO_BEAM_BATCH] % cfg.vocab_size
            out_lb, steps, ms = zoo_run(
                torch, "llama beams", "llama", cfg, False,
                lambda: llama.generate_beam(params, cfg, bpl,
                                            ZOO_LLAMA_BEAM_NEW, ZOO_BEAM_K))
            report(f"llama_7b (2 layers) beams K {ZOO_BEAM_K} B "
                   f"{ZOO_BEAM_BATCH}", "llama", cfg, False,
                   lambda: llama.generate_beam(params, cfg, bpl,
                                               ZOO_LLAMA_BEAM_NEW,
                                               ZOO_BEAM_K), out_lb, steps, ms)
            out_lb = tuple(x.cpu() for x in out_lb)

            def lbeams_job(host=host, cfg=cfg, bpl=bpl, out_lb=out_lb):
                zoo_beams_match(torch, "llama beams", out_lb,
                                llama.generate_beam(
                                    host, cfg, bpl, ZOO_LLAMA_BEAM_NEW,
                                    ZOO_BEAM_K, device="cpu"))
            after.append(lbeams_job)
        del params

    # ---- bench_zoo and run_zoo: subprocesses, the card to themselves, while
    # the CPU's checks finish -------------------------------------------------
    for job in after:
        cpu_check(job)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    bench_argv = ["--model", "gpt_350m", "--batch", str(ZOO_BATCH),
                  "--in-len", str(ZOO_SHORT), "--gen-tokens", str(ZOO_NEW),
                  "--iters", "3"]
    run_ids = ["5", "11", "17", "23"]

    def run_zoo(family):
        return subprocess.Popen(
            [sys.executable, "-m", "whisper_trtllm_tpu_torch.cli.run_zoo",
             "--family", family, "--prompt-ids", *run_ids,
             "--max-new-tokens", "16"], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    children = {
        "bench_zoo": subprocess.Popen(
            [sys.executable, "-m", "whisper_trtllm_tpu_torch.benchmarks."
             "benchmark", *bench_argv], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "run_zoo": run_zoo("gpt"), "run_zoo bloom": run_zoo("bloom"),
        "run_zoo chatglm6b": run_zoo("chatglm6b")}
    t_wait = time.perf_counter()
    for job in jobs:
        job.result()
    cpu.shutdown()
    outs = {}
    for name, child in children.items():
        try:
            stdout, stderr = child.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            child.kill()
            stdout, stderr = child.communicate()
        if child.returncode != 0:
            fail(f"zoo {name} exited {child.returncode}:\n{stdout[-3000:]}\n"
                 f"{stderr[-3000:]}")
        outs[name] = json.loads(stdout.strip().splitlines()[-1])
    print(f"zoo: waited {time.perf_counter() - t_wait:.2f} s for the CPU "
          f"checks and the subprocesses")
    row = outs["bench_zoo"]
    if not (row["tokens_per_s"] > 0 and math.isfinite(row["latency_ms_p50"])
            and row["launches"].get("decode_attn") and
            row["launches"].get("layer_norm")):
        fail(f"zoo bench_zoo: {row}")
    print(f"zoo bench_zoo gpt_350m: {json.dumps(row)}")
    tiny = gpt.GPTConfig.testing()
    seq = np.asarray(outs["run_zoo"]["output_ids"], np.int32)
    tp = gpt.init_params(tiny, seed=0, device="cpu")
    n = zoo_tokens_match(torch, "run_zoo", gpt.forward(tp, tiny, seq[None])[0],
                         seq, len(run_ids), tiny.eos_token_id)
    print(f"zoo run_zoo --family gpt: {outs['run_zoo']['output_ids']}, equal "
          f"to the CPU's argmax over {n} steps")
    for fam, mod, tiny in (("bloom", bloom, bloom.BloomConfig.testing()),
                           ("chatglm6b", chatglm6b,
                            chatglm6b.ChatGLM6BConfig.testing())):
        row = outs[f"run_zoo {fam}"]
        seq = np.asarray(row["output_ids"], np.int32)
        tp = mod.init_params(tiny, seed=0, device="cpu")
        logits = cpu_forward(mod, tp, tiny)(seq[None], len(run_ids))[0]
        n = zoo_tokens_match(torch, f"run_zoo {fam}", logits, seq,
                             len(run_ids), tiny.eos_token_id)
        print(f"zoo run_zoo --family {fam}: {row['output_ids']}, equal to "
              f"the CPU's argmax over {n} steps")
    return {"": counts, **wide_counts, **alibi_counts}


# --------------------------------------------------------------------------
# phase 2c: the causal LMs' in-flight and paged runtimes, BERT, the UNet
# --------------------------------------------------------------------------

IFB_LANES, IFB_PROMPT, IFB_NEW, IFB_SEGMENT = 4, 800, 32, 16
# 8 requests of 770..800 tokens in two waves of 4 (the second reuses the
# lanes the first leaves)
IFB_LENGTHS = (800, 770, 790, 780, 795, 775, 800, 785)
# the paged pool at 16 tokens a block: 160 blocks against the dense
# equivalent's 4 x ceil(832 / 16) = 208, so the fourth request of a wave
# waits on blocks (an admit takes ceil(801 / 16) = 51)
IFB_TPB, IFB_BLOCKS = 16, 160
IFB_TRACED = (800, 790)
PAGED_BEAM_K, PAGED_BEAM_PROMPT, PAGED_BEAM_NEW = 4, 800, 32
PAGED_BEAM_BLOCKS = 80
BERT_BATCH, BERT_LEN = 8, 512
# BERT-large's row 0 on the card against the port's CPU forward: fp32 sums
# over up to 4096 terms in another order through 24 post-LN layers, K1's
# products as 3xTF32 (~2^-22 an operand), on LayerNorm outputs of unit scale
BERT_TOLERANCE = 1e-3
UNET_BATCH, UNET_HW, UNET_CTX = 2, 64, 77
# the UNet's first sample on the card against the port's CPU forward at
# batch 1, relative to max |CPU|: fp32 sums in another order over ~70
# layers of convolutions and products (cuDNN's algorithms, not the CPU's)
UNET_TOLERANCE = 1e-3


def lm_batcher_launches(cfg, steps: int, admits: int) -> dict:
    """A batcher's launches: a step K2 L and K5 2L + 1; an admit's prefill
    (its prompt padded to 800 positions) K1 L and K5 2L + 1."""
    n = cfg.n_layer
    return {"flash_fwd": n * admits, "decode_attn": n * steps,
            "layer_norm": (2 * n + 1) * (steps + admits)}


def zoo_runtimes(torch, np, card, trees) -> dict:
    """Phase 2c: gpt_350m's dense and paged in-flight batchers and paged
    beams, BERT-large and the UNet at SD-1.x's widths and depth on the
    card; returns the launches of each path's first run under "_ifb",
    "_ifb_paged", "_beam_paged", "_bert" and "_unet"."""
    from whisper_trtllm_tpu_torch.models import bert, gpt, unet
    from whisper_trtllm_tpu_torch.models.gpt import model as gm
    from whisper_trtllm_tpu_torch.ops.kernels import (
        KERNELS,
        reset_launch_counts,
    )
    from whisper_trtllm_tpu_torch.runtime import beam_paged
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt
    from whisper_trtllm_tpu_torch.runtime.ifb_lm import (
        CausalLMInflightBatcher,
    )
    from whisper_trtllm_tpu_torch.runtime.ifb_paged import (
        PagedCausalLMInflightBatcher,
    )
    from whisper_trtllm_tpu_torch.utils.checkpoint import params_from_numpy

    rng = np.random.default_rng(SEED + 23)
    counts = {}

    def launches():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in KERNELS.items()}

    def expect(tag, got, want):
        full = {k: 0 for k in KERNELS}
        full.update(want)
        if got != full:
            fail(f"{tag}: launches {got}, expected {full}")

    # ---- gpt_350m: the dense and the paged batcher ------------------------
    cfg, host = trees["gpt_350m"]
    params = params_from_numpy(host, DEVICE)
    prompts = [rng.integers(3, cfg.vocab_size, (n,)).astype(np.int32)
               for n in IFB_LENGTHS]
    common = dict(cache_heads=cfg.n_head, head_dim=cfg.head_dim,
                  n_layer=cfg.n_layer, eos_token_id=cfg.eos_token_id,
                  num_lanes=IFB_LANES, max_prompt_len=IFB_PROMPT,
                  max_new_tokens=IFB_NEW, segment_steps=IFB_SEGMENT,
                  device=DEVICE)

    def build(paged):
        if paged:
            return PagedCausalLMInflightBatcher(
                params, cfg,
                prefill=lambda p, t, l, pk, pv, tb: gm._prefill_paged(
                    p, cfg, t, l, pk, pv, tb),
                step=lambda p, tok, pos, pk, pv, tb: gm._step_paged(
                    p, cfg, tok, pos, pk, pv, tb),
                num_blocks=IFB_BLOCKS, tokens_per_block=IFB_TPB, **common)
        return CausalLMInflightBatcher(
            params, cfg,
            prefill=lambda p, t, l, ck, cv: gm._prefill_ragged(
                p, cfg, t, l, ck, cv),
            step=lambda p, tok, pos, ck, cv: gm._step(p, cfg, tok, pos, ck,
                                                      cv), **common)

    def drain(b, wave):
        rids = [b.submit(p) for p in wave]
        b.run()
        return [b.fetch(r) for r in rids]

    rows, step_ms = {}, {}
    for kind in ("dense", "paged"):
        paged = kind == "paged"
        torch.cuda.synchronize()
        gen_rt.reset_loop_counts()
        t0 = time.perf_counter()
        b = build(paged)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        reset_launch_counts()
        t0 = time.perf_counter()
        got = []
        for wave in (prompts[:IFB_LANES], prompts[IFB_LANES:]):
            if paged:
                # the first admission pass: the pool holds three prompts
                rids = [b.submit(p) for p in wave]
                b._retire_and_admit()
                held = sum(r is not None for r in b._lane_req)
                if held == IFB_LANES or not b._queue:
                    fail(f"ifb paged: {held} lanes admitted at once, "
                         f"{len(b._queue)} waiting: admission never waited "
                         f"on blocks")
                b.run()
                got += [b.fetch(r) for r in rids]
            else:
                got += drain(b, wave)
        torch.cuda.synchronize()
        drain_ms = (time.perf_counter() - t0) * 1e3
        want = lm_batcher_launches(cfg, b.steps_run, len(prompts))
        expect(f"ifb {kind}", launches(), want)
        counts["_ifb_paged" if paged else "_ifb"] = want
        loop = gen_rt.LOOP
        if (loop.captures, loop.eager_steps, loop.replays) != (
                1, gen_rt.WARMUP_STEPS, b.steps_run):
            fail(f"ifb {kind}: {loop.captures} captures, {loop.eager_steps} "
                 f"eager steps, {loop.replays} replays for {b.steps_run} "
                 f"steps run")
        if paged and b.free_blocks() != IFB_BLOCKS:
            fail(f"ifb paged: {b.free_blocks()} of {IFB_BLOCKS} blocks free "
                 f"after run()")
        # a replay's device ms (every lane idle does the same work as live
        # ones: the step is the same graph)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            b._graph.replay()
        end.record()
        torch.cuda.synchronize()
        step_ms[kind] = start.elapsed_time(end) / 20
        gen_rt.LOOP.replays -= 20
        # the profiler's count over a traced drain of two more requests
        wave_steps, box = b.steps_run, {}

        def traced_drain(b=b):
            before = b.steps_run
            drain(b, [prompts[0][:n] for n in IFB_TRACED])
            box["steps"] = b.steps_run - before
        _, traced, counted = traced_run(torch, traced_drain, ENGINE_SYMBOLS)
        if {k: traced[k] for k in ZOO_KERNELS} != {k: counted[k]
                                                   for k in ZOO_KERNELS}:
            fail(f"ifb {kind} traced: profiler {traced} != counters "
                 f"{counted}")
        want_t = lm_batcher_launches(cfg, box["steps"], len(IFB_TRACED))
        if {k: counted[k] for k in ZOO_KERNELS} != {
                k: want_t[k] for k in ZOO_KERNELS}:
            fail(f"ifb {kind} traced: counters {counted}, expected {want_t}")
        rows[kind] = got
        print(f"zoo runtimes: gpt_350m {kind} batcher, {IFB_LANES} lanes, "
              f"{len(prompts)} requests of {min(IFB_LENGTHS)}..."
              f"{max(IFB_LENGTHS)} tokens in two waves, {IFB_NEW} new: "
              f"{wave_steps} steps, build "
              f"(capture) {build_ms:.2f} ms, drains {drain_ms:.2f} ms, "
              f"{step_ms[kind]:.4f} ms a replayed step; launches {want} "
              f"exact, one capture, replays only; a traced drain's "
              f"{counted} equal the profiler's [{card}]")
        del b
    print(f"zoo runtimes: a paged step {step_ms['paged']:.4f} ms against the "
          f"dense batcher's {step_ms['dense']:.4f} ms "
          f"({step_ms['paged'] / step_ms['dense']:.3f}x) [{card}]")
    for i, (d, p) in enumerate(zip(rows["dense"], rows["paged"])):
        if not np.array_equal(d, p):
            fail(f"ifb: request {i} paged {p[len(prompts[i]):].tolist()} != "
                 f"dense {d[len(prompts[i]):].tolist()}")

    # each request against its own lockstep run at batch 1 (a near tie on
    # the CPU, where they part, is printed and ends that request)
    cpu_fwd = []
    for i, prompt in enumerate(prompts):
        lane = gpt.generate(params, cfg, prompt[None], IFB_NEW,
                            device=DEVICE).cpu().numpy()[0]
        row = rows["dense"][i]
        n = min(row.size, lane.size)
        if np.array_equal(row[:n], lane[:n]):
            continue
        at = int(np.nonzero(row[:n] != lane[:n])[0][0])
        cpu_fwd.append((i, at, lane[:at]))
    for i, at, seq in cpu_fwd:
        logits = gpt.forward(host, cfg, seq[None])[0]
        top2 = torch.topk(logits[at - 1].float(), 2).values
        gap = (top2[0] - top2[1]).item()
        if gap >= ZOO_GAP * logits[at - 1].abs().max().item():
            fail(f"ifb: request {i} parts from its lockstep run at position "
                 f"{at} (CPU top-two gap {gap:.3e})")
        print(f"zoo runtimes: request {i} parts from its lockstep run at a "
              f"near tie, position {at} (CPU top-two gap {gap:.3e})")
    print(f"zoo runtimes: the paged batcher's rows equal the dense one's; "
          f"{len(prompts) - len(cpu_fwd)} of {len(prompts)} requests equal "
          f"their lockstep run at batch 1 whole")

    # ---- gpt_350m: paged beams against the dense beam search ---------------
    bprompt = rng.integers(3, cfg.vocab_size, (PAGED_BEAM_PROMPT,)).astype(
        np.int32)
    mgrs = []
    init = beam_paged.PagedKVCache.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        mgrs.append(self)

    beam_paged.PagedKVCache.__init__ = spy
    tpb = IFB_TPB
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, scores, lens = beam_paged.paged_beam_search(
            lambda p, t, l, pk, pv, tb: gm._prefill_paged(
                p, cfg, t, l, pk, pv, tb),
            lambda p, tok, pos, pk, pv, tb: gm._step_paged(
                p, cfg, tok, pos, pk, pv, tb),
            params, bprompt,
            pool_shape=(cfg.n_layer, PAGED_BEAM_BLOCKS, tpb, cfg.n_head,
                        cfg.head_dim),
            tokens_per_block=tpb,
            max_blocks_per_seq=math.ceil(
                (PAGED_BEAM_PROMPT + PAGED_BEAM_NEW) / tpb),
            max_new_tokens=PAGED_BEAM_NEW, eos_token_id=cfg.eos_token_id,
            num_beams=PAGED_BEAM_K, device=DEVICE)
        beam_ms = (time.perf_counter() - t0) * 1e3
    finally:
        beam_paged.PagedKVCache.__init__ = init
    got = launches()
    steps = got["decode_attn"] // cfg.n_layer
    want = {"flash_fwd": cfg.n_layer, "decode_attn": cfg.n_layer * steps,
            "layer_norm": (2 * cfg.n_layer + 1) * (1 + steps)}
    expect("paged beams", got, want)
    counts["_beam_paged"] = want
    (mgr,) = mgrs
    if mgr.ledger.free != PAGED_BEAM_BLOCKS or len(mgr):
        fail(f"paged beams: {mgr.ledger.free} of {PAGED_BEAM_BLOCKS} blocks "
             f"free after the search")
    dtoks, dscores, dlens = (x.cpu().numpy()[0] for x in gpt.generate_beam(
        params, cfg, bprompt[None], PAGED_BEAM_NEW, PAGED_BEAM_K,
        device=DEVICE))
    diff = float(np.abs(scores - dscores).max())
    if not (np.array_equal(toks, dtoks) and np.array_equal(lens, dlens)
            and diff <= ZOO_BEAM_SCORE_TOLERANCE):
        fail(f"paged beams: tokens {toks[:, PAGED_BEAM_PROMPT:].tolist()} "
             f"lengths {lens.tolist()} scores {scores.tolist()} against the "
             f"dense search's {dtoks[:, PAGED_BEAM_PROMPT:].tolist()} "
             f"{dlens.tolist()} {dscores.tolist()}")
    print(f"zoo runtimes: gpt_350m paged beams K {PAGED_BEAM_K} from "
          f"{PAGED_BEAM_PROMPT} (tpb {tpb}, {PAGED_BEAM_BLOCKS} blocks), "
          f"{PAGED_BEAM_NEW} new, eager steps: {steps} steps "
          f"{beam_ms:.2f} ms; tokens and lengths equal the dense beam "
          f"search's, scores within {diff:.3e}; every block released; "
          f"launches {want} exact [{card}]")
    del params

    # ---- BERT-large and the UNet: the card's runs; the CPU's references
    # in a thread beside them (no trace from here on) ------------------------
    bcfg, bhost = trees["bert_large"]
    btok = rng.integers(0, bcfg.vocab_size, (BERT_BATCH, BERT_LEN)).astype(
        np.int32)
    bmask = np.ones((BERT_BATCH, BERT_LEN), np.int32)
    for i in range(1, BERT_BATCH):
        bmask[i, BERT_LEN - 37 * i:] = 0
    ucfg, uhost = trees["unet"]
    sample = rng.standard_normal((UNET_BATCH, UNET_HW, UNET_HW,
                                  ucfg.in_channels)).astype(np.float32)
    ts = np.asarray([10.0, 500.0], np.float32)[:UNET_BATCH]
    ctx = rng.standard_normal((UNET_BATCH, UNET_CTX,
                               ucfg.cross_attention_dim)).astype(np.float32)

    def cpu_refs():
        t0 = time.perf_counter()
        out = {"bert": bert.forward(bhost, bcfg, btok[:1])[0][0],
               "bert masked": bert.forward(bhost, bcfg, btok[1:2],
                                           bmask[1:2])[0][0]}
        out["bert_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["unet"] = unet.forward(uhost, ucfg, sample[:1], ts[:1],
                                   ctx[:1])[0]
        out["unet_s"] = time.perf_counter() - t0
        return out

    cpu = ThreadPoolExecutor(1)
    ref = cpu.submit(cpu_refs)

    bert_counts = {"flash_fwd": bcfg.n_layer,
                   "layer_norm": 2 * bcfg.n_layer + 1}
    bert_out = {}
    for dn, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        bparams = params_from_numpy(bhost, DEVICE, dtype)
        for masked in (False, True):
            m = bmask if masked else None
            reset_launch_counts()
            (seq, pooled), ms, _, _ = timed(
                torch, lambda: bert.forward(bparams, bcfg, btok, m), reps=3)
            want = {"flash_fwd": 0 if masked else 3 * bcfg.n_layer,
                    "layer_norm": 3 * (2 * bcfg.n_layer + 1)}
            expect(f"bert_large {dn} masked={masked}", launches(), want)
            if not (torch.isfinite(seq).all() and torch.isfinite(pooled).all()
                    and seq.shape == (BERT_BATCH, BERT_LEN, bcfg.d_model)):
                fail(f"bert_large {dn} masked={masked}: output "
                     f"{tuple(seq.shape)} not finite")
            bert_out[dn, masked] = seq.float().cpu()
            print(f"zoo runtimes: bert_large {dn} B {BERT_BATCH} x "
                  f"{BERT_LEN} masked={masked}: {ms:.3f} ms a forward, "
                  f"{BERT_BATCH * BERT_LEN / ms * 1e3:.0f} tokens/s; "
                  f"launches a forward {dict((k, v // 3) for k, v in want.items())} "
                  f"exact [{card}]")
        del bparams
    counts["_bert"] = bert_counts
    for masked in (False, True):
        d = (bert_out["bfloat16", masked] - bert_out["float32", masked]
             ).abs().max().item()
        print(f"zoo runtimes: bert_large bf16 masked={masked} within {d:.3e} "
              f"of fp32 (printed, not gated)")

    uparams = params_from_numpy(uhost, DEVICE)
    # a Transformer2D block: K1 for its self and its cross attention, K5
    # for its three LayerNorms (SD-1.x: 16 blocks, K1 32, K5 48)
    blocks = sum(len(blk["attns"]) for blk in uhost["down"] + [uhost["mid"]]
                 + uhost["up"])
    unet_counts = {"flash_fwd": 2 * blocks, "layer_norm": 3 * blocks}
    reset_launch_counts()
    out, ms, lo, hi = timed(
        torch, lambda: unet.forward(uparams, ucfg, sample, ts, ctx), reps=3)
    expect("unet fp32", launches(), {k: 3 * v for k, v in
                                     unet_counts.items()})
    again = unet.forward(uparams, ucfg, sample, ts, ctx)
    if not torch.equal(again, out):
        fail("unet fp32: a repeat call gave other outputs")
    if not (torch.isfinite(out).all() and out.shape == (
            UNET_BATCH, UNET_HW, UNET_HW, ucfg.out_channels)):
        fail(f"unet fp32: output {tuple(out.shape)} not finite")
    counts["_unet"] = unet_counts
    print(f"zoo runtimes: unet (SD-1.x widths and depth) fp32 B "
          f"{UNET_BATCH} {UNET_HW}x{UNET_HW} over {UNET_CTX} context rows: "
          f"{ms:.3f} ms a forward ({lo:.3f}..{hi:.3f}); launches a forward "
          f"{unet_counts} exact ({blocks} Transformer2D blocks); a repeat "
          f"call equal [{card}]")
    del uparams
    u16 = params_from_numpy(uhost, DEVICE, torch.bfloat16)
    reset_launch_counts()
    out16, ms, _, _ = timed(
        torch, lambda: unet.forward(u16, ucfg, sample, ts, ctx), reps=3)
    expect("unet bf16", launches(), {k: 3 * v for k, v in
                                     unet_counts.items()})
    if not torch.isfinite(out16).all():
        fail("unet bf16: output not finite")
    d16 = ((out16.float() - out).abs().max() / out.abs().max()).item()
    print(f"zoo runtimes: unet bf16: {ms:.3f} ms a forward, within "
          f"{d16:.3e} of fp32 relative to max |fp32| (printed, not gated) "
          f"[{card}]")
    del u16

    # ---- bench_zoo bert_large as a subprocess, while the CPU finishes ------
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child = subprocess.Popen(
        [sys.executable, "-m", "whisper_trtllm_tpu_torch.benchmarks."
         "benchmark", "--model", "bert_large", "--batch", str(BERT_BATCH),
         "--in-len", str(BERT_LEN), "--iters", "3"], cwd=ROOT, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    t_wait = time.perf_counter()
    refs = ref.result()
    cpu.shutdown()
    try:
        stdout, stderr = child.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        child.kill()
        stdout, stderr = child.communicate()
    if child.returncode != 0:
        fail(f"bench_zoo bert_large exited {child.returncode}:\n"
             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    row = json.loads(stdout.strip().splitlines()[-1])
    if not (row["tokens_encoded_per_s"] > 0 and row["sequences_per_s"] > 0
            and row["launches"].get("flash_fwd") == 3 * bcfg.n_layer
            and row["launches"].get("layer_norm") == 3 * (
                2 * bcfg.n_layer + 1)):
        fail(f"bench_zoo bert_large: {row}")
    print(f"zoo runtimes: waited {time.perf_counter() - t_wait:.2f} s for "
          f"the CPU's references (BERT {refs['bert_s']:.1f} s, UNet "
          f"{refs['unet_s']:.1f} s) and bench_zoo")
    print(f"zoo runtimes bench_zoo bert_large: {json.dumps(row)}")
    for tag, got, want in (
            ("bert_large row 0", bert_out["float32", False][0], refs["bert"]),
            ("bert_large masked row 1", bert_out["float32", True][1][
                :int(bmask[1].sum())], refs["bert masked"][
                    :int(bmask[1].sum())])):
        err = (got - want).abs().max().item()
        if not math.isfinite(err) or err > BERT_TOLERANCE:
            fail(f"{tag}: max |card - CPU| = {err:.3e} > {BERT_TOLERANCE}")
        print(f"zoo runtimes: {tag} fp32 within {err:.3e} of the CPU's "
              f"(limit {BERT_TOLERANCE})")
    want = refs["unet"]
    err = ((out[0].cpu() - want).abs().max() / want.abs().max()).item()
    if not math.isfinite(err) or err > UNET_TOLERANCE:
        fail(f"unet: the first sample's max |card - CPU| / max |CPU| = "
             f"{err:.3e} > {UNET_TOLERANCE}")
    print(f"zoo runtimes: unet's first sample fp32 within {err:.3e} of the "
          f"CPU's at batch 1, relative to max |CPU| {want.abs().max():.3f} "
          f"(limit {UNET_TOLERANCE})")
    return counts


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="the checkout of an earlier commit: its K1, K2, "
                         "K3, K5, K6, K7 and K8 are built from its csrc/ and "
                         "timed beside these")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    import numpy as np

    sys.path.insert(0, ROOT)
    import threading

    from whisper_trtllm_tpu_torch import native
    from whisper_trtllm_tpu_torch.ops.kernels import _build
    from whisper_trtllm_tpu_torch.utils.device import set_fp32_precision

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase_s = {}
    t0 = time.perf_counter()
    # libwtpu.so (g++, the serving path's native library) beside the kernels
    native_build = {}
    gpp = threading.Thread(target=lambda: native_build.update(
        path=native.build_native(), s=time.perf_counter() - t0))
    gpp.start()
    try:
        _build.build(SOURCES)
    finally:
        gpp.join()
    phase_s["build"] = time.perf_counter() - t0
    if "path" not in native_build:
        fail("the native library did not build")
    print(f"build: {phase_s['build']:.2f} s for {len(SOURCES)} "
          f"sources (nvcc -gencode arch=compute_90a,code=sm_90a) and "
          f"{native_build['path']} (g++, {native_build['s']:.2f} s)")
    for src in SOURCES:
        log = _build.library_path(src).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {src}: {line.strip()}")

    parent = load_parent(args.parent) if args.parent else None
    set_fp32_precision()
    # the zoo phase's weights, drawn on the host (numpy releases the GIL
    # while it fills an array) while the kernels run on the card
    zoo_pool = ThreadPoolExecutor(1)
    zoo_trees = zoo_pool.submit(zoo_weights)
    t0 = time.perf_counter()

    def rng(tag):
        return CardRng(torch, tag)

    flash = check_flash(torch, rng("flash"), card, parent=parent)
    decode = check_decode(torch, rng("decode"), card, parent)
    decode["serving"] = check_decode_quant(torch, rng("decode quant"), card,
                                           parent)
    stft = check_stft(torch, rng("stft"), card, parent)
    floor_ms = launch_floor(torch, card)
    norm = check_layer_norm(torch, rng("layer norm"), card, floor_ms, parent)
    fused = check_fused(torch, rng("fused"), card, parent)
    flash_bwd = check_flash_bwd(torch, rng("flash bwd"), card)
    cross = check_cross(torch, rng("cross"), card, parent)
    gelu = check_gelu(torch, rng("gelu"), card, floor_ms, parent)
    norm["floor_ms"] = gelu["floor_ms"] = floor_ms
    # every kernel of the bench's paths at their shapes: K1, K2
    # (quantized), K3 and K5 at the headline's and the sections' widths, K6
    # at the benchmark grid's
    check_flash(torch, rng("bench flash"), card, BENCH_FLASH_CASES)
    check_decode_quant(torch, rng("bench decode quant"), card, parent,
                       BENCH_QUANT_CASES)
    check_stft(torch, rng("bench stft"), card, parent, BENCH_STFT_CASES)
    check_layer_norm(torch, rng("bench layer norm"), card, floor_ms, parent,
                     BENCH_NORM_CASES)
    check_fused(torch, rng("bench fused"), card, parent, BENCH_FUSED_CASES)
    # and the beam phase's (K2, K5 and K6 at B·K = 16 lanes)
    check_decode_quant(torch, rng("beam decode quant"), card, parent,
                       BEAM_QUANT_CASES)
    check_layer_norm(torch, rng("beam layer norm"), card, floor_ms, parent,
                     BEAM_NORM_CASES)
    check_fused(torch, rng("beam fused"), card, parent, BEAM_FUSED_CASES)
    # the in-flight batcher's K2 (8 lanes at lengths 1..225)
    decode["batcher"] = check_decode_batcher(torch, rng("batcher"), card)
    # the zoo's: K1 at its causal prefills (GQA included), K2 at its steps
    flash["zoo"] = check_flash(torch, rng("zoo flash"), card,
                               ZOO_FLASH_CASES)
    decode["zoo"] = check_decode_zoo(torch, rng("zoo decode"), card)
    # and GPT-J's and GPT-NeoX's: K1 and K2 at heads of 256 and 96, K5 at
    # widths 4096 to 12288 (from streams of their own)
    flash["zoo"].update(check_flash(torch, rng("zoo wide flash"), card,
                                    ZOO_WIDE_FLASH_CASES))
    decode["zoo"].update(check_decode_zoo(torch, rng("zoo wide decode"),
                                          card, ZOO_WIDE_DECODE_CASES))
    # and Bloom's: K2 with ALiBi's bias (ChatGLM's step is "llama step")
    decode["bias"] = check_decode_bias(torch, rng("zoo decode bias"), card)
    norm["zoo"] = check_layer_norm(torch, rng("zoo layer norm"), card,
                                   floor_ms, cases=ZOO_NORM_CASES)
    # phase 2c's: K1 at the UNet's self and cross attentions (S != T, head
    # dims 40, 80, 160) and BERT-large's encoder
    flash["zoo"].update(check_flash(torch, rng("unet flash"), card,
                                    UNET_FLASH_CASES))
    phase_s["kernels"] = time.perf_counter() - t0
    # the zoo, its weights drawn on the host beside the kernels phase
    t0 = time.perf_counter()
    trees = zoo_trees.result()
    zoo_pool.shutdown()
    del zoo_trees
    zoo_counts = zoo(torch, np, card, trees)
    phase_s["zoo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo_counts.update(zoo_runtimes(torch, np, card, trees))
    del trees
    phase_s["zoo runtimes"] = time.perf_counter() - t0
    # each kernel's launches from a path that runs it: configuration B, the
    # serving precision, for K1, K2, K3 and K5; E, the float-weight path,
    # for K6; one training step for K4; the hardware check's
    # cross_attn_kernel for K7; the example's main() for K8
    counts = {"zoo": zoo_counts}
    t0 = time.perf_counter()
    counts["gpu_check"], counts["example"] = hardware_check(card)
    phase_s["hardware check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts.update(end_to_end(torch, np, card))
    phase_s["end to end"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode_features(torch, np, card)
    phase_s["decode features"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    beam_counts = beams_and_longform(torch, np, card)
    phase_s["beams and long-form"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec_counts = speculative(torch, np, card)
    phase_s["speculative"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clis_and_engine(torch, np, card)
    phase_s["clis and engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_counts = serving(torch, np, card)
    phase_s["serving"] = time.perf_counter() - t0
    # what the decode phases leave on the card: their sessions are gone, and
    # with them every captured step (an entry goes with its weights)
    from whisper_trtllm_tpu_torch.runtime import generation as gen_rt

    torch.cuda.synchronize()
    print(f"after the decode phases: {len(gen_rt._GRAPHS)} captured steps "
          f"cached, {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
          f"allocated on the card")
    if gen_rt._GRAPHS:
        fail("captured steps outlived the sessions whose weights they read")
    t0 = time.perf_counter()
    counts["train"] = training(torch, np, card)
    phase_s["training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    local_heads = parallel(torch, np, card)
    phase_s["parallel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts["bench"], bench_k6 = bench_phase(torch, np, card)
    counts["bench"]["fused_decoder_layer_step"] = bench_k6
    phase_s["bench"] = time.perf_counter() - t0
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in phase_s.items()))

    rows = [
        dict(name="flash_fwd", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/flash_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/flash_attention.py:89",
             **flash),
        dict(name="decode_attn", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/decode_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/decode_attention.py:80",
             **decode),
        dict(name="stft_log_mel", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/stft.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/stft.py:76", **stft),
        dict(name="layer_norm", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/layer_norm.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/layer_norm.py:50", **norm),
        dict(name="fused_decoder_layer_step", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/fused_decoder_step.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/fused_decoder_step.py:259",
             **fused),
        dict(name="flash_bwd", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/flash_attention.py:181",
             **flash_bwd),
        dict(name="cross_decode_mha", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/cross_attention.cu",
             replaces="whisper_trtllm_tpu/ops/pallas/cross_attention.py:86",
             **cross),
        dict(name="fused_bias_gelu", route="cuda",
             source="whisper_trtllm_tpu_torch/csrc/fused_bias_gelu.cu",
             replaces="examples/custom_kernel/custom_gelu_kernel.py:37",
             **gelu),
    ]
    path = {"fused_decoder_layer_step": "E", "flash_bwd": "train",
            "cross_decode_mha": "gpu_check", "fused_bias_gelu": "example"}
    for r in rows:
        r["launches"] = counts[path.get(r["name"], "B")][r["name"]]
        # the bench's path: its headline pass (K1, K2, K3, K5) and the
        # benchmark CLI's float32 batch-8 row (K6)
        if counts["bench"].get(r["name"]):
            r["bench_launches"] = counts["bench"][r["name"]]
        # the beam path's first transcribe: B for K1, K2, K3, K5; E for K6
        beam_path = beam_counts["E" if r["name"] == "fused_decoder_layer_step"
                                else "B"]
        if beam_path.get(r["name"]):
            r["beam_launches"] = beam_path[r["name"]]
        # the in-flight batcher's first drain in int8-auto (K1, K2, K3, K5)
        if serve_counts.get(r["name"]):
            r["serve_launches"] = serve_counts[r["name"]]
        # one speculative utterance: S1 (gamma 4) for K1, K2, K3, K5; S2
        # (the random draft's steps) for K6
        spec_path = spec_counts["S2" if r["name"] == "fused_decoder_layer_step"
                                else "S1"]
        if spec_path.get(r["name"]):
            r["spec_launches"] = spec_path[r["name"]]
        # K1, K2 and K4 at the local head counts of tensor parallelism
        if r["name"] in local_heads:
            r["local_heads"] = local_heads[r["name"]]
        # gpt_350m's lockstep call at prompt 800 (K1, K2, K5), GPT-J's and
        # GPT-NeoX's at batch 2, bloom_560m's (K2 with its bias, K5) and
        # ChatGLM-6B's (K2, K5)
        # and phase 2c's: the batchers' first drains, the paged beams,
        # BERT-large's forward and the UNet's
        for tag in ("", "_gptj", "_gptneox", "_bloom", "_chatglm6b", "_ifb",
                    "_ifb_paged", "_beam_paged", "_bert", "_unet"):
            if counts["zoo"][tag].get(r["name"]):
                r["zoo_launches" + tag] = counts["zoo"][tag][r["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    # K1, K4 and K5 also carry their bf16 numbers at the encoder's shape;
    # K2 its bf16 float case and the serving precision (int8 T-minor, bf16
    # q) at the cross case; K5 its decode step's, K8 the encoder MLP's
    # shape, both beside the launch floor
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + [x for x in ("bench_launches",
                                              "beam_launches",
                                              "serve_launches",
                                              "spec_launches",
                                              "zoo_launches",
                                              "zoo_launches_gptj",
                                              "zoo_launches_gptneox",
                                              "zoo_launches_bloom",
                                              "zoo_launches_chatglm6b",
                                              "zoo_launches_ifb",
                                              "zoo_launches_ifb_paged",
                                              "zoo_launches_beam_paged",
                                              "zoo_launches_bert",
                                              "zoo_launches_unet",
                                              "bfloat16",
                                              "serving", "batcher", "decode",
                                              "encoder_mlp", "floor_ms",
                                              "local_heads", "zoo", "bias")
                                  if x in r]}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
