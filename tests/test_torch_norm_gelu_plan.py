"""The launch plans of LayerNorm (K5, ``whisper_trtllm_tpu_torch/csrc/
layer_norm.cu``) and of the bias+GELU example (K8, ``csrc/fused_bias_gelu.cu``)
replayed on the CPU, and K5's order of sums replayed in numpy fp32 against
the JAX package's Pallas kernel in interpret mode.

K5 (``norm_plan``): a group of ``lpr`` lanes shares a row; lane l of the
group holds the vectors l, l + lpr, ... (``vpt`` of them, ``vec`` values
each); ``32 // lpr`` rows a warp; every warp walks its rows a grid's stride
apart while its first row lies inside x (a condition the whole warp
shares). Each lane sums its values in order, vector by vector, then the
group adds its partial sums over an xor tree (offsets 16, 8, 4, 2, 1 below
lpr); mean = sum * (1 / d); the variance is a second pass over the values
held, the same tree; rstd = rsqrt(var * (1 / d) + eps).

Rows wider than 2048 take a block a row (``lpr`` = the block's threads,
``rpw`` 0): thread t holds the vectors t, t + threads, ...; each warp adds
its threads' partial sums over the same xor tree, then every thread adds
the warps' sums in warp order.

K8 (``gelu_plan``): a block is ``tx`` column threads by ``ty`` rows;
thread x takes the vectors x, x + tx, ... (``cpt`` of them) of its column
chunk (the grid's y) and walks its rows a grid's stride apart.

The kernel launches at most one wave of the plan's blocks, so coverage is
checked for the plan's blocks and for fewer. The limits of the sum order:
1e-6 of max(|ref|, 1) in fp32 and one bf16 step on bf16 outputs, against
the Pallas kernel and against the plain version.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401
from whisper_trtllm_tpu.ops.pallas.layer_norm import layer_norm_fused
from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel import (
    MAX_CPT,
    gelu_plan,
)
from whisper_trtllm_tpu_torch.examples.custom_kernel.custom_gelu_kernel import (
    THREADS as GELU_THREADS,
)
from whisper_trtllm_tpu_torch.ops.kernels import _build
from whisper_trtllm_tpu_torch.ops.kernels.layer_norm import (
    HALF_VPTS,
    MAX_D,
    MAX_WIDE_THREADS,
    SCALAR_VPTS,
    THREADS,
    VECTOR_VPTS,
    WIDE_SCALAR_VPTS,
    WIDE_THREADS,
    WIDE_VPTS,
    layer_norm_reference,
    norm_plan,
)

WIDTHS = [6, 100, 384, 1280, 2048]
ROWS = [1, 4, 37, 6000]
ELEMS = {"float32": 4, "bfloat16": 2}
MAX_THREADS = 256   # both kernels' __launch_bounds__
WAVE = 132 * 4      # fewer blocks than a plan's, as one wave may launch


def _waves(blocks):
    return sorted({blocks, max(1, min(blocks, WAVE)), max(1, blocks // 3)})


# --------------------------------------------------------------------------
# K5: the launch plan
# --------------------------------------------------------------------------

def _norm_rows_covered(plan, rows, grid):
    """How often each row is stored: warp w's row groups g take rows
    w * rpw + g + k * stride while the warp's first row lies inside x."""
    warps = grid * plan.threads // 32
    stride = warps * plan.rpw
    counts = np.zeros(rows, np.int64)
    first = np.arange(warps) * plan.rpw
    k = 0
    while True:
        base = first + k * stride
        live = base < rows
        if not live.any():
            return counts
        r = (base[live, None] + np.arange(plan.rpw)[None, :]).ravel()
        np.add.at(counts, r[r < rows], 1)
        k += 1


def _norm_columns_covered(plan, d):
    """How often each of a row's d values is held by one of its lanes."""
    counts = np.zeros(d, np.int64)
    nv = d // plan.vec
    for gl in range(plan.lpr):
        for v in range(plan.vpt):
            j = gl + plan.lpr * v
            if j < nv:
                counts[j * plan.vec:(j + 1) * plan.vec] += 1
    return counts


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", list(ELEMS))
@pytest.mark.parametrize("d", WIDTHS)
def test_norm_plan_takes_every_value_once(d, dtype, rows, aligned):
    elem = ELEMS[dtype]
    plan = norm_plan(rows, d, elem, aligned)
    wide = 16 // elem
    # what the C entry point takes
    assert plan.lpr in (1, 2, 4, 8, 16, 32) and plan.rpw == 32 // plan.lpr
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert plan.lpr * plan.vpt * plan.vec >= d and d % plan.vec == 0
    if plan.vec == wide:
        assert plan.vpt in VECTOR_VPTS
    elif plan.vec == wide // 2:   # 8-byte vectors fill 32 lanes exactly
        assert plan.vpt in HALF_VPTS and plan.lpr == 32
        assert plan.lpr * plan.vpt * plan.vec == d
    else:
        assert plan.vec == 1 and plan.vpt in SCALAR_VPTS
    # the vector path only where d and the pointers allow it
    if not aligned:
        assert plan.vec == 1
    elif d % wide == 0:
        assert plan.vec > 1
    # rows that fit in one block get one block of just the warps they need
    warps = -(-rows // plan.rpw)
    if warps * 32 <= THREADS:
        assert plan.blocks == 1 and plan.threads == warps * 32
    else:
        assert plan.threads == THREADS
        assert plan.blocks == -(-warps // (THREADS // 32))
    assert (_norm_columns_covered(plan, d) == 1).all()
    for grid in _waves(plan.blocks):
        assert (_norm_rows_covered(plan, rows, grid) == 1).all()


# the zoo's widths (GPT-J, ChatGLM 4096; GPT-NeoX 6144; opt_66b 9216;
# gpt_175b 12288), the limit, and widths off the 16-byte vector
WIDE_WIDTHS = [2056, 4096, 4100, 6144, 9216, 12288, 12290, MAX_D]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", [1, 2, 1600])
@pytest.mark.parametrize("dtype", list(ELEMS))
@pytest.mark.parametrize("d", WIDE_WIDTHS)
def test_wide_norm_plan_takes_every_value_once(d, dtype, rows, aligned):
    """A block a row: at least two warps, at most WIDE_THREADS where
    that holds the row (MAX_WIDE_THREADS at most), the fewest instantiated
    vectors a thread; every value of a row held once, every row taken once
    by the blocks of any wave."""
    elem = ELEMS[dtype]
    plan = norm_plan(rows, d, elem, aligned)
    wide = 16 // elem
    assert plan.lpr == plan.threads and plan.rpw == 0
    assert plan.threads % 32 == 0 and 64 <= plan.threads <= MAX_WIDE_THREADS
    assert plan.vec == (wide if aligned and d % wide == 0 else 1)
    assert plan.vpt in (WIDE_VPTS if plan.vec > 1 else WIDE_SCALAR_VPTS)
    assert plan.lpr * plan.vpt * plan.vec >= d and plan.blocks == rows
    nv = d // plan.vec
    fits = [v for v in (WIDE_VPTS if plan.vec > 1 else WIDE_SCALAR_VPTS)
            if -(-nv // v) <= WIDE_THREADS]
    if fits:
        assert plan.vpt == fits[0] and plan.threads <= WIDE_THREADS
    assert (_norm_columns_covered(plan, d) == 1).all()
    for grid in _waves(plan.blocks):
        hit = np.zeros(rows, np.int64)
        for b in range(grid):
            np.add.at(hit, np.arange(b, rows, grid), 1)
        assert (hit == 1).all()


def test_norm_plan_at_the_main_paths_shapes():
    """The encoder's rows take 16-byte vectors (bf16: 16 lanes of 3, two
    rows a warp, as the design sets out); the decode step's 4 rows take 32
    lanes of 3 vectors, 8-byte ones in bf16."""
    assert tuple(norm_plan(6000, 384, 2, True)) == (8, 16, 3, 2, 128, 750)
    assert tuple(norm_plan(6000, 384, 4, True)) == (4, 32, 3, 1, 128, 1500)
    assert tuple(norm_plan(4, 384, 2, True)) == (4, 32, 3, 1, 128, 1)
    assert tuple(norm_plan(4, 384, 4, True)) == (4, 32, 3, 1, 128, 1)


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("what", ["x", "scale", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_path_only_on_16_byte_boundaries(dtype, what, offset):
    """The wrappers take the vector path only when x, y, scale and bias
    all start on 16 bytes: a view ``offset`` values into its storage is off
    that boundary unless offset * itemsize is a multiple of 16."""
    d, rows = 384, 37
    views = {}
    for name, n in (("x", rows * d), ("scale", d), ("bias", d)):
        k = offset if name == what else 0
        views[name] = torch.zeros(n + k + 64, dtype=dtype)[k:k + n]
    item = views["x"].element_size()
    aligned = _build.aligned16(*views.values())
    assert aligned == (offset * item % 16 == 0)
    plan = norm_plan(rows, d, item, aligned)
    assert (plan.vec > 1) == aligned
    gplan = gelu_plan(rows, d, item, _build.aligned16(views["x"],
                                                      views["bias"]))
    assert (gplan.vec > 1) == (what == "scale" or aligned)


# --------------------------------------------------------------------------
# K8: the launch plan
# --------------------------------------------------------------------------

def _gelu_covered(plan, rows, d, grid):
    """How often each element of x (rows, d) is computed: column vectors
    cy * tx * cpt + cx + tx * c of chunk cy, rows bx * ty + ry + k * grid
    * ty."""
    nv = d // plan.vec
    cols = np.zeros(d, np.int64)
    for cy in range(plan.chunks):
        for cx in range(plan.tx):
            for c in range(plan.cpt):
                j = cy * plan.tx * plan.cpt + cx + plan.tx * c
                if j < nv:
                    cols[j * plan.vec:(j + 1) * plan.vec] += 1
    start = np.arange(grid * plan.ty)
    rows_hit = np.zeros(rows, np.int64)
    for k in range(-(-rows // len(start))):
        r = start + k * len(start)
        np.add.at(rows_hit, r[r < rows], 1)
    return cols, rows_hit


_GELU_SHAPES = ([(r, d) for r in ROWS for d in WIDTHS]
                + [(512, 384), (6000, 1536), (7, 33), (3, 100003)])


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", list(ELEMS))
@pytest.mark.parametrize("rows,d", _GELU_SHAPES)
def test_gelu_plan_takes_every_element_once(rows, d, dtype, aligned):
    elem = ELEMS[dtype]
    plan = gelu_plan(rows, d, elem, aligned)
    wide = 16 // elem
    assert plan.vec == (wide if aligned and d % wide == 0 else 1)
    assert 1 <= plan.cpt <= MAX_CPT and plan.tx * plan.ty <= GELU_THREADS
    assert plan.chunks * plan.tx * plan.cpt * plan.vec >= d
    assert plan.chunks <= 65535 and plan.blocks == -(-rows // plan.ty)
    for grid in _waves(plan.blocks):
        cols, rows_hit = _gelu_covered(plan, rows, d, grid)
        assert (cols == 1).all() and (rows_hit == 1).all()


# --------------------------------------------------------------------------
# K5: the order of sums against the Pallas kernel and the plain version
# --------------------------------------------------------------------------

def emulate_layer_norm(x, scale, bias, plan, eps=1e-5):
    """K5's arithmetic in numpy fp32 for x (rows, d) and its plan: each
    lane's partial sums over its vectors in order, the xor tree over the
    lane group (a block a row: over each warp, then the warps in order),
    the second pass for the variance, then the output."""
    rows, d = x.shape
    f32 = np.float32
    nv = d // plan.vec
    gl = np.arange(plan.lpr)
    slots = []  # (columns, held) of each of a lane's values, in order
    for v in range(plan.vpt):
        j = gl + plan.lpr * v
        held = j < nv
        for e in range(plan.vec):
            slots.append((np.where(held, j * plan.vec + e, 0), held))

    def tree(part):
        for off in (16, 8, 4, 2, 1):
            if off < plan.lpr:
                part = part + part[:, gl ^ off]
        if plan.rpw:
            return part[:, 0]
        total = np.zeros(rows, f32)  # a block a row: the warps in order
        for w in range(plan.lpr // 32):
            total = total + part[:, 32 * w]
        return total

    inv_d = f32(1) / f32(d)
    total = np.zeros((rows, plan.lpr), f32)
    for col, held in slots:
        total = total + np.where(held, x[:, col], f32(0))
    mean = tree(total) * inv_d
    sq = np.zeros((rows, plan.lpr), f32)
    for col, held in slots:
        dv = x[:, col] - mean[:, None]
        sq = sq + np.where(held, dv * dv, f32(0))
    rstd = f32(1) / np.sqrt(tree(sq) * inv_d + f32(eps))
    return ((x - mean[:, None]) * rstd[:, None] * scale + bias).astype(f32)


def _bf16_steps(a, b):
    """|a - b| in bf16 steps at the larger magnitude (both bf16 values)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -126)
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) - 7)


@functools.lru_cache(maxsize=None)
def _case(shape, x_dtype, p_dtype):
    """Inputs (rounded to their dtypes, as fp32 numpy) and the Pallas
    kernel's output in interpret mode, as fp32 numpy."""
    rng = np.random.default_rng(shape[-1] + shape[1])
    d = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2
                         + 0.5).to(getattr(torch, x_dtype))
    scale = torch.from_numpy(1 + 0.5 * rng.standard_normal(d).astype(
        np.float32)).to(getattr(torch, p_dtype))
    bias = torch.from_numpy(0.5 * rng.standard_normal(d).astype(
        np.float32)).to(getattr(torch, p_dtype))
    jx, js, jb = (jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in (x, scale, bias))
    ref = np.asarray(layer_norm_fused(jx, js, jb, interpret=True).astype(
        jnp.float32))
    return x, scale, bias, ref


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("x_dtype,p_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
@pytest.mark.parametrize("shape", [(4, 1, 384), (2, 37, 384), (3, 5, 100),
                                   (2, 3, 2048)])
def test_kernel_sum_order_matches_pallas_and_plain(shape, x_dtype, p_dtype,
                                                   aligned):
    x, scale, bias, pallas = _case(shape, x_dtype, p_dtype)
    d = shape[-1]
    rows = x.numel() // d
    plan = norm_plan(rows, d, x.element_size(), aligned)
    out = emulate_layer_norm(x.float().numpy().reshape(rows, d),
                             scale.float().numpy(), bias.float().numpy(),
                             plan).reshape(shape)
    plain = layer_norm_reference(x, scale, bias).float().numpy()
    assert pallas.shape == plain.shape == out.shape
    if x_dtype == "float32":
        for ref in (pallas, plain):
            err = np.abs(out - ref) / np.maximum(np.abs(ref), 1)
            assert err.max() <= 1e-6
    else:
        got = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
        for ref in (pallas, plain):
            assert _bf16_steps(got, ref).max() <= 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("x_dtype,p_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
@pytest.mark.parametrize("shape", [(1, 8, 4096), (1, 8, 6144), (1, 8, 12288),
                                   (2, 3, 4100)])
def test_wide_sum_order_matches_pallas_and_plain(shape, x_dtype, p_dtype,
                                                 aligned):
    """A block a row, against the Pallas kernel and the plain version:
    1e-6 of max(|ref|, 1) in fp32; on bf16 outputs one bf16 step of
    max(|ref|, 1), the limit K5 is held to on the card (the Pallas kernel
    and the plain version themselves part by 2 steps of an output's own
    magnitude where (x - mean) * rstd * scale nearly cancels the bias at
    d 4096)."""
    x, scale, bias, pallas = _case(shape, x_dtype, p_dtype)
    d = shape[-1]
    rows = x.numel() // d
    plan = norm_plan(rows, d, x.element_size(), aligned)
    assert plan.rpw == 0
    out = emulate_layer_norm(x.float().numpy().reshape(rows, d),
                             scale.float().numpy(), bias.float().numpy(),
                             plan).reshape(shape)
    plain = layer_norm_reference(x, scale, bias).float().numpy()
    if x_dtype == "float32":
        limit = 1e-6
    else:
        out = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
        limit = 2.0 ** -7
    for ref in (pallas, plain):
        err = np.abs(out - ref) / np.maximum(np.abs(ref), 1)
        assert err.max() <= limit
