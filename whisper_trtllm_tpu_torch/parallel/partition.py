"""Parameter partition specs and the cut of a Whisper tree over the model
axis (counterpart of ``whisper_trtllm_tpu/parallel/partition.py``, its
Whisper half).

Specs are tuples, one entry a dim: "model" on the dim cut over the model
axis, None elsewhere, ``()`` replicated. As in the JAX package, q/k/v (or
the fused qkv) and fc1 are column-parallel (cut on the output dim), out and
fc2 row-parallel (cut on the input dim), and the LayerNorms, the
convolutions and the embeddings are replicated; weight-only int8/int4
projections and the int8 vocab table adapt their specs
(``_adapt_specs_to_quantized``). fp8 and SmoothQuant projections have no
specs here, as there, and ``shard_params`` refuses them.

Where the JAX package hands the specs to GSPMD, ``shard_params`` cuts the
tree itself and returns plain tensors, this rank's shards, which the
kernels and captured graphs take as they are. The cut follows
``torch.chunk``: ceil(n / tp) units a rank in rank order, the last ranks
fewer or none, the layout DTensor's ``Shard`` and DCP assume on a dim of
units (``utils/checkpoint.py::save_sharded``). On an attention projection a
unit is a whole head, so 6 heads over 4 ranks are 2, 2, 2 and 0; on the MLP
it is a column. A fused qkv projection is cut as q, k and v each by heads,
concatenated on the rank (the JAX package cuts the concatenated dim evenly
and GSPMD keeps its meaning; the same cut done by hand would give rank 0
only q). int4 packs pairs of output columns into a byte, so a rank's
columns must pair up.

``shard_params`` records the layout against the tree; the model reads it
(``local_model``): the model axis's group and this rank's head counts, and
it refuses to run a tree cut over more than one model rank outside its
mesh, or a tree whose widths are not the config's without a layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from whisper_trtllm_tpu_torch.parallel.collectives import gather_data
from whisper_trtllm_tpu_torch.parallel.mesh import (
    Mesh,
    axis_group,
    axis_rank,
    axis_size,
    current_mesh,
)

Path = Tuple[str, ...]
COL = (None, None, "model")
ROW = (None, "model", None)


def _attn_spec(fused: bool = False) -> dict:
    col = {"kernel": COL, "bias": (None, "model")}
    col_nobias = {"kernel": COL}
    row = {"kernel": ROW, "bias": (None,)}
    if fused:
        return {"qkv": dict(col), "out": row}
    return {"q": dict(col), "k": col_nobias, "v": dict(col), "out": row}


def _ln_spec() -> dict:
    return {"scale": (None, None), "bias": (None, None)}


def _layer_specs(has_cross: bool, fused: bool = False) -> dict:
    spec = {
        "self_attn": _attn_spec(fused),
        "self_attn_layer_norm": _ln_spec(),
        "fc1": {"kernel": COL, "bias": (None, "model")},
        "fc2": {"kernel": ROW, "bias": (None,)},
        "final_layer_norm": _ln_spec(),
    }
    if has_cross:
        spec["encoder_attn"] = _attn_spec()
        spec["encoder_attn_layer_norm"] = _ln_spec()
    return spec


def param_partition_specs(fused_qkv: bool = False) -> dict:
    """The spec tree of ``models.whisper.init_params``' structure
    (``fused_qkv=True`` for a tree from ``fuse_qkv_params``)."""
    return {
        "encoder": {
            "conv1": {"kernel": (), "bias": ()},
            "conv2": {"kernel": (), "bias": ()},
            "embed_positions": (),
            "layers": _layer_specs(has_cross=False, fused=fused_qkv),
            "layer_norm": {"scale": (), "bias": ()},
        },
        "decoder": {
            "embed_tokens": (),       # replicated: the vocab head reads it all
            "embed_positions": (),
            "layers": _layer_specs(has_cross=True, fused=fused_qkv),
            "layer_norm": {"scale": (), "bias": ()},
        },
    }


def _adapt_specs_to_quantized(params, specs):
    """Rewrite a spec subtree for weight-only-quantized dense dicts: the
    int8/int4 ``kernel_q``/``kernel_q4`` takes the float kernel's spec and
    the per-output-channel ``scale`` the kernel's output-dim spec (a
    column-parallel projection keeps its scales local); the int8 vocab
    table's values and per-row scales take the table's spec on their first
    dim."""
    if not isinstance(params, dict):
        return specs
    if "table_q" in params and not isinstance(specs, dict):
        return {"table_q": specs, "scale": tuple(specs)[:1]}
    if isinstance(specs, dict) and "kernel" in specs and (
            "kernel_q" in params or "kernel_q4" in params):
        parts = tuple(specs["kernel"])
        # scale shape = kernel shape minus the input dim (second-to-last)
        scale_spec = parts[:-2] + parts[-1:] if len(parts) >= 2 else ()
        out = {("kernel_q" if "kernel_q" in params else "kernel_q4"): parts,
               "scale": scale_spec}
        if "bias" in params and "bias" in specs:
            out["bias"] = specs["bias"]
        return out
    if isinstance(specs, dict):
        return {k: _adapt_specs_to_quantized(params.get(k), v)
                for k, v in specs.items() if k in params}
    return specs


def default_specs(params: dict) -> dict:
    """The specs of ``params``' structure: fused or not, quantized or not."""
    fused = "qkv" in params.get("decoder", {}).get("layers", {}).get(
        "self_attn", {})
    return _adapt_specs_to_quantized(params,
                                     param_partition_specs(fused_qkv=fused))


def leaves_with_specs(params, specs, path: Path = ()):
    """(path, leaf, spec) of every leaf, in the tree's order. The tree and
    the specs must have the same structure, as ``jax.tree_util.tree_map``
    demands of them (an fp8 or SmoothQuant projection has none: its dict
    holds leaves the specs do not name)."""
    if isinstance(params, dict):
        if not isinstance(specs, dict) or set(specs) != set(params):
            names = sorted(specs) if isinstance(specs, dict) else specs
            raise ValueError(
                f"shard_params: the tree at {'/'.join(path) or '/'} (keys "
                f"{sorted(params)}) does not match its partition specs "
                f"({names}); fp8 and SmoothQuant projections are not sharded")
        for k in params:
            yield from leaves_with_specs(params[k], specs[k], path + (k,))
    else:
        if isinstance(specs, dict):
            raise ValueError(f"shard_params: a leaf at {'/'.join(path)} "
                             f"where the specs hold a subtree")
        yield path, params, tuple(specs)


def chunk_range(n: int, tp: int, rank: int) -> Tuple[int, int]:
    """(start, size) of rank ``rank``'s units among ``n`` cut over ``tp``
    ranks with ``torch.chunk`` semantics."""
    per = -(-n // tp)
    start = min(rank * per, n)
    return start, min(start + per, n) - start


@dataclass(frozen=True)
class Cut:
    """How a leaf's dim ``dim`` is cut over the model axis: viewed as
    (``groups``, ``count``, ``unit``), ``count`` is cut in whole units.
    groups is 3 for a fused qkv projection (q, k and v each cut), else 1;
    a unit is a head (its head_dim columns, halved for packed int4) on an
    attention projection and a column on the MLP."""

    dim: int
    groups: int
    count: int
    unit: int

    def view(self, shape: tuple, count: Optional[int] = None) -> tuple:
        """``shape`` with ``dim`` split into (groups, count, unit), for a
        shard of ``count`` units (all of them by default)."""
        n = self.count if count is None else count
        return (tuple(shape[:self.dim]) + (self.groups, n, self.unit)
                + tuple(shape[self.dim + 1:]))

    def local(self, x: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
        """Rank ``rank``'s shard of the whole leaf ``x``."""
        start, n = chunk_range(self.count, tp, rank)
        v = x.reshape(self.view(x.shape)).narrow(self.dim + 1, start, n)
        return v.reshape(tuple(x.shape[:self.dim]) + (self.groups * n
                                                       * self.unit,)
                         + tuple(x.shape[self.dim + 1:]))


def leaf_cut(path: Path, shape: tuple, spec: tuple, heads: Optional[dict],
             tp: int) -> Optional[Cut]:
    """The cut of the leaf at ``path`` (None: replicated). ``heads`` maps
    "encoder"/"decoder" to the config's head counts; the attention
    projections need it."""
    if "model" not in spec:
        return None
    dim = spec.index("model")
    size = shape[dim]
    where = "/".join(path)
    if len(path) >= 3 and path[-3] in ("self_attn", "encoder_attn"):
        if heads is None:
            raise ValueError(f"shard_params needs the model config: {where} "
                             f"is cut by whole heads")
        groups = 3 if path[-2] == "qkv" else 1
        h = heads[path[0]]
        if size % (groups * h):
            raise ValueError(f"shard_params: {where} has {size} columns, "
                             f"not {groups} x {h} heads")
        return Cut(dim, groups, h, size // (groups * h))
    if path[-1] == "kernel_q4" and dim == len(shape) - 1:
        per = -(-2 * size // tp)
        if per % 2:
            raise ValueError(f"shard_params: {where} packs pairs of int4 "
                             f"columns, and {2 * size} columns over {tp} "
                             f"ranks leave {per} on a rank")
    return Cut(dim, 1, size, 1)


def _heads(cfg) -> Optional[dict]:
    if cfg is None:
        return None
    return {"encoder": cfg.encoder_attention_heads,
            "decoder": cfg.decoder_attention_heads}


def tree_cuts(params: dict, cfg=None, specs: Optional[dict] = None,
              tp: int = 1) -> Dict[Path, Cut]:
    """The cut of every leaf of a whole tree that the specs cut."""
    specs = default_specs(params) if specs is None else \
        _adapt_specs_to_quantized(params, specs)
    cuts = {}
    for path, leaf, spec in leaves_with_specs(params, specs):
        cut = leaf_cut(path, tuple(leaf.shape), spec, _heads(cfg), tp)
        if cut is not None:
            cuts[path] = cut
    return cuts


@dataclass(frozen=True, eq=False)
class Layout:
    """What ``shard_params`` did to a tree: its mesh, the model axis's size,
    this rank's coordinate on it and its group (None at one rank), and the
    cut of each cut leaf (of the whole tree's shapes)."""

    mesh: Mesh
    tp: int
    rank: int
    group: object
    cuts: Dict[Path, Cut]


_LAYOUTS = WeakIdKeyDictionary()


def _key(params) -> Optional[torch.Tensor]:
    """The leaf a tree's layout is recorded against: a replicated leaf of
    every Whisper tree, which ``shard_params`` makes anew."""
    try:
        return params["decoder"]["layer_norm"]["scale"]
    except (KeyError, TypeError):
        return None


def layout_of(params) -> Optional[Layout]:
    key = _key(params)
    return None if key is None else _LAYOUTS.get(key)


def record(params: dict, layout: Layout) -> dict:
    """Record ``layout`` against ``params`` (a tree of this rank's shards:
    ``shard_params``, ``utils.checkpoint.load_sharded``, or a tree made
    from a sharded one leaf by leaf, as the train step's detached leaves)."""
    _LAYOUTS[_key(params)] = layout
    return params


def adopt(tree: dict, params: dict) -> dict:
    """``tree``, made leaf by leaf from ``params``, under ``params``'
    layout (if it has one)."""
    layout = layout_of(params)
    return tree if layout is None else record(tree, layout)


def make_layout(mesh: Mesh, cuts: Dict[Path, Cut]) -> Layout:
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    return Layout(mesh, axis_size(mesh, "model"), axis_rank(mesh, "model"),
                  axis_group(mesh, "model"), cuts)


def set_path(tree: dict, path: Path, value) -> None:
    """``tree[path[0]][path[1]]... = value``, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def shard_params(params: dict, mesh: Mesh, specs: Optional[dict] = None,
                 cfg=None) -> dict:
    """This rank's shards of ``params`` as a tree of new tensors on the
    mesh's device (copies: an in-place update of one tree never reaches the
    other), its layout recorded. ``cfg`` (the ``WhisperConfig``) gives the
    head counts the attention projections are cut by. Handles fused-QKV
    and weight-only-quantized trees; raises where the JAX package's
    ``shard_params`` fails (fp8 and SmoothQuant projections, an odd int4
    cut)."""
    specs = default_specs(params) if specs is None else \
        _adapt_specs_to_quantized(params, specs)
    tp = axis_size(mesh, "model")
    layout = make_layout(mesh, {})
    out: dict = {}
    for path, leaf, spec in leaves_with_specs(params, specs):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.array(leaf))
        cut = leaf_cut(path, tuple(t.shape), spec, _heads(cfg), tp)
        if cut is not None:
            layout.cuts[path] = cut
            t = cut.local(t, tp, layout.rank)
        set_path(out, path, t.to(mesh.device_type, copy=True).contiguous())
    return record(out, layout)


class Local(NamedTuple):
    """What the model runs a tree at on this rank: the model axis's group
    (None at one rank: no collective) and this rank's head counts."""

    group: object
    encoder_heads: int
    decoder_heads: int


def _check_whole(params: dict, cfg) -> None:
    """A tree without a layout must have the config's widths: a rank's
    shards run without their collectives would return partial sums."""
    for side, ffn in (("encoder", cfg.encoder_ffn_dim),
                      ("decoder", cfg.decoder_ffn_dim)):
        fc2 = params.get(side, {}).get("layers", {}).get("fc2", {})
        kernel = next((v for k, v in fc2.items() if k.startswith("kernel")),
                      None)
        if kernel is not None and kernel.shape[-2] != ffn:
            raise RuntimeError(
                f"the {side}'s fc2 takes {kernel.shape[-2]} inputs where the "
                f"config has {ffn}: a model-axis shard runs only as "
                f"shard_params made it, inside its mesh")


def local_model(params: dict, cfg) -> Local:
    """The group and head counts the model runs ``params`` at. A tree cut
    over more than one model rank runs only inside its own mesh."""
    layout = layout_of(params)
    if layout is None:
        _check_whole(params, cfg)
        return Local(None, cfg.encoder_attention_heads,
                     cfg.decoder_attention_heads)
    if layout.tp > 1 and current_mesh() is not layout.mesh:
        raise RuntimeError(
            f"this tree is cut over a model axis of {layout.tp} ranks: it "
            f"runs only inside its mesh (with mesh: ...)")
    return Local(layout.group,
                 chunk_range(cfg.encoder_attention_heads, layout.tp,
                             layout.rank)[1],
                 chunk_range(cfg.decoder_attention_heads, layout.tp,
                             layout.rank)[1])


def leaves(tree, path: Path = ()):
    """(path, leaf) of every leaf of a nested dict, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def gather_params(params: dict) -> dict:
    """The whole tree from the model ranks' shards (every rank of the
    model axis calls it; a padded all-gather a cut leaf), on every rank;
    ``params`` itself when it is not cut over more than one rank."""
    layout = layout_of(params)
    if layout is None or layout.tp == 1:
        return params
    out: dict = {}
    for path, leaf in leaves(params):
        cut = layout.cuts.get(path)
        if cut is not None:
            per = -(-cut.count // layout.tp)
            n = chunk_range(cut.count, layout.tp, layout.rank)[1]
            # the rank's units first, padded to every rank's count
            v = leaf.reshape(cut.view(leaf.shape, n)).movedim(cut.dim + 1, 0)
            v = torch.cat([v, v.new_zeros((per - n,) + v.shape[1:])])
            whole = gather_data(v, layout.group)[:cut.count].movedim(
                0, cut.dim + 1)
            leaf = whole.reshape(tuple(leaf.shape[:cut.dim])
                                 + (cut.groups * cut.count * cut.unit,)
                                 + tuple(leaf.shape[cut.dim + 1:]))
        set_path(out, path, leaf)
    return out
