"""Sharding rules: the reference's parameter / batch / cache specs for a
mesh, and the cut of a port model into one rank's serving state.

The specs are the reference's (``repro.launch.sharding``), entry for entry:
each leaf's spec is a tuple with one entry per dimension -- None
(replicated), an axis name, or a tuple of two or more axis names -- where
the reference returns a ``PartitionSpec`` of the same entries (which reads
a one-axis tuple as the axis name, as here).  The rules: tensor
parallelism over ``model`` on the heads / d_ff / vocab / expert-ffn dims,
ZeRO-3 over the data axes on the other dim, a dim sharded only when the
axis size divides it; the attention caches' sequence dim over ``model``
(the K-parallel layout flash-decode reads); under ``moe_ep`` the expert
panels over their expert dim.  The trees are nested dicts / lists whose
leaves have a ``.shape`` (the reference's parameter layout:
``models.weights.to_numpy_params``; the cache dict of
``models.model.make_cache``).

What a rank holds when it serves (``shard_block`` / ``serving_state``) is
the reference's *result*, not its full layout: the expert panels cut on
their expert dimension under expert parallelism (``expert_axis``), the KV
cache cut on its sequence dimension under ``sp_decode``
(``models.model.make_cache``), everything else replicated.

What a rank holds when it trains on a mesh is the full layout the
reference's GSPMD applies: ``shard_params`` cuts every parameter of a
port model to its block under ``param_specs`` (ZeRO-3 over the data axes,
tensor parallelism over ``model``) and tags it with its spec
(``p.mesh_spec``); the AdamW moments, drawn like the blocks, follow, or
take specs of their own that cut them further over the data axes
(``shard_opt_state``: ZeRO-1, the parameters TP only and the moments at
ZeRO-3).  At
use, ``gathered`` brings each block to the layout the local compute
reads: the data axes' cut gathered (``collective.zero_gather``: the
gradient summed over those axes in fp32 and cut back to the block), the
model axis's cut kept where the local compute runs tensor-parallel on it
(the column panels ``wq wk wv w_gate w_up``, the row panels ``wo
w_down``, ``out_proj`` under ``ssm_head_shard``, the expert dim under
expert parallelism; such a tensor carries ``model_cut`` = (mesh, model
axis), which ``models.layers`` reads) and gathered elsewhere
(``collective.gather``: the ranks of ``model`` compute on the same rows).
``full_tensor`` / ``load_blocks`` carry blocks to and from the
reference's whole tree for checkpoints, and ``cut_batch`` takes this
rank's rows of a global batch under ``batch_specs``.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.dist import current_dist
from ..core.gemm import collective
from .mesh import Mesh

_REPLICATED = {
    "ln1", "ln2", "ln_cross", "ln", "norm", "final_norm", "enc_norm",
    "A_log", "D_skip", "dt_bias", "conv_b", "q_norm", "k_norm", "step",
}
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "patch_proj",
        "frame_proj"}            # (in=dp, out=model)
_ROW = {"wo", "w_down", "out_proj"}   # (in=model, out=dp)
_STACKED = {"layers", "encoder"}
_EXPERT_PANELS = ("w_gate", "w_up", "w_down")


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def expert_axis(mesh: Mesh, moe_ep: bool, moe_ep_axis: str = "dp",
                num_experts: int | None = None):
    """The mesh axis (or axis tuple) that owns the MoE expert dim under
    expert parallelism, or None when EP is off, the axis is trivial or the
    expert count does not divide it.  ``moe_ep_axis`` is "dp" (the data
    axes) or a mesh axis name; the result is what ``DistContext.moe_ep_axis``
    carries, so the executors and the weights' cut agree."""
    if not moe_ep:
        return None
    if moe_ep_axis == "dp":
        axes = dp_axes(mesh)
    elif moe_ep_axis in mesh.axis_names:
        axes = (moe_ep_axis,)
    else:
        return None
    n = axis_size(mesh, axes) if axes else 1
    if n <= 1 or (num_experts is not None and num_experts % n):
        return None
    return axes if len(axes) > 1 else axes[0]


def _maybe(dim: int, axes, mesh: Mesh):
    """Shard ``dim`` over ``axes`` only when divisible."""
    if axes is None:
        return None
    n = axis_size(mesh, axes)
    return axes if (n > 1 and dim % n == 0) else None


def _leaf_spec(path_names: list[str], shape, mesh: Mesh) -> tuple:
    name = path_names[-1]
    stacked = int(any(p in _STACKED for p in path_names[:-1]))
    dims = shape[stacked:]
    dp = dp_axes(mesh) or None

    def spec(*parts):
        return (None,) * stacked + parts

    if name in _REPLICATED or len(dims) == 0:
        return spec(*([None] * len(dims)))
    if name == "embed":
        return (_maybe(dims[0], "model", mesh), _maybe(dims[1], dp, mesh))
    if name == "router":
        return spec(_maybe(dims[0], dp, mesh), None)
    if name == "conv_w":
        return spec(None, _maybe(dims[1], "model", mesh))
    if name in _COL:
        if len(dims) == 3:     # moe experts (E, D, F)
            return spec(None, _maybe(dims[1], dp, mesh),
                        _maybe(dims[2], "model", mesh))
        return spec(_maybe(dims[0], dp, mesh), _maybe(dims[1], "model", mesh))
    if name in _ROW:
        if len(dims) == 3:     # moe experts (E, F, D)
            return spec(None, _maybe(dims[1], "model", mesh),
                        _maybe(dims[2], dp, mesh))
        return spec(_maybe(dims[0], "model", mesh), _maybe(dims[1], dp, mesh))
    return spec(*([None] * len(dims)))


def _normal(spec: tuple) -> tuple:
    """A one-axis tuple entry as its axis name (``PartitionSpec``'s
    reading)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _map_with_path(fn, tree, path=()):
    """``fn(path_names, leaf)`` over a nested dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return _normal(fn(list(path), tree))


def _param_spec(names: list[str], shape: tuple, mesh: Mesh, zero_stage: int,
                moe_ep: bool, moe_ep_axis: str) -> tuple:
    spec = _leaf_spec(names, shape, mesh)
    name = names[-1]
    stacked = int(any(p in _STACKED for p in names[:-1]))
    dims = shape[stacked:]
    dp = dp_axes(mesh) or None
    if moe_ep and name in (_COL | _ROW) and len(dims) == 3:
        e_ax = dp if moe_ep_axis == "dp" else "model"
        other = dp if moe_ep_axis != "dp" else None
        parts = [None] * stacked + [_maybe(dims[0], e_ax, mesh), None, None]
        if name in _COL:   # (E, D, F)
            parts[stacked + 1] = _maybe(dims[1], other, mesh)
            parts[stacked + 2] = (_maybe(dims[2], "model", mesh)
                                  if moe_ep_axis == "dp" else None)
        else:              # (E, F, D)
            parts[stacked + 1] = (_maybe(dims[1], "model", mesh)
                                  if moe_ep_axis == "dp" else None)
            parts[stacked + 2] = _maybe(dims[2], other, mesh)
        return tuple(parts)
    if zero_stage < 3:
        return tuple(None if p is not None and p != "model" else p
                     for p in spec)
    return spec


def param_specs(params_shape, mesh: Mesh, *, zero_stage: int = 3,
                moe_ep: bool = False, moe_ep_axis: str = "dp"):
    """Spec tree matching a parameter (or optimizer-state) tree.
    ``zero_stage`` 3: weights 2-D sharded (TP x ZeRO); 0 / 1: TP only.
    ``moe_ep``: the expert panels sharded on their EXPERT dim over
    ``moe_ep_axis`` ("dp" or a mesh axis), the other weight dim
    ZeRO-sharded over the data axes when EP rides the model axis."""
    return _map_with_path(
        lambda names, leaf: _param_spec(names, tuple(leaf.shape), mesh,
                                        zero_stage, moe_ep, moe_ep_axis),
        params_shape)


def batch_specs(cfg, batch_shape, mesh: Mesh):
    dp = dp_axes(mesh) or None

    def per_leaf(names, leaf):
        shape = tuple(leaf.shape)
        return (_maybe(shape[0], dp, mesh),) + (None,) * (len(shape) - 1)

    return _map_with_path(per_leaf, batch_shape)


def reference_cache_specs(cfg, cache_shape, mesh: Mesh):
    """The reference's decode / prefill cache specs: B over dp, the
    sequence over model (K-parallel; the cross K / V's encoder rows too),
    the SSM state's head dim and the conv window's channels over model."""
    dp = dp_axes(mesh) or None

    def walk(names, leaf):
        name = names[-1] if names else ""
        s = tuple(leaf.shape)
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v",
                    "h", "ssm_h"):
            # (L|G, B, S, KVH, hd) / (L, B, H, P, N)
            return (None, _maybe(s[1], dp, mesh),
                    _maybe(s[2], "model", mesh), None, None)
        if name in ("conv", "ssm_conv"):   # (L, B, W-1, C)
            return (None, _maybe(s[1], dp, mesh), None,
                    _maybe(s[3], "model", mesh))
        return (None,) * len(s)

    return _map_with_path(walk, cache_shape)


@dataclass(frozen=True)
class HeadChannels:
    """The conv window's channel entry under ``ssm_head_shard``: of its
    ``d_inner + 2N`` channels, the first ``d_inner`` (the heads' ``x``) are
    cut over ``axis`` and the ``2N`` of B and C are whole on every rank
    (``models.ssm._heads``)."""
    axis: str
    d_inner: int

    def block(self, size: int, mesh: Mesh) -> int:
        return self.d_inner // mesh.axis_size(self.axis) + size - self.d_inner


def cache_specs(cfg, cache_shape, mesh: Mesh, *, head_shard: bool = False):
    """The decode / prefill caches as the port holds them: B over dp; the
    self-attention caches' sequence over model (the K-parallel layout
    flash-decode reads), as the reference; the cross K / V of the encoder
    rows whole (the reference cuts their rows over model where it divides
    them); the SSM state and conv window whole, or with ``head_shard``
    (``ssm_head_shard``) the state's heads over model and the window as
    ``HeadChannels`` -- the reference cuts the heads and the window's
    channels in contiguous blocks either way (``reference_cache_specs``;
    the bytes differ, ROADMAP Queue 3)."""
    dp = dp_axes(mesh) or None

    def walk(names, leaf):
        name = names[-1] if names else ""
        s = tuple(leaf.shape)
        rows = (None, _maybe(s[1], dp, mesh))
        if name in ("k", "v", "attn_k", "attn_v"):
            return rows + (_maybe(s[2], "model", mesh), None, None)
        if name in ("h", "ssm_h"):         # (L, B, H, P, N)
            heads = _maybe(s[2], "model", mesh) if head_shard else None
            return rows + (heads, None, None)
        if name in ("cross_k", "cross_v"):
            return rows + (None, None, None)
        if name in ("conv", "ssm_conv"):   # (L, B, W-1, C)
            d_inner = 2 * cfg.d_model
            cut = head_shard and _maybe(d_inner, "model", mesh) is not None
            return rows + (None, HeadChannels("model", d_inner) if cut
                           else None)
        return (None,) * len(s)

    return _map_with_path(walk, cache_shape)


def block_shape(shape: tuple, spec: tuple, mesh: Mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``
    (an entry per dim: None, axes, or ``HeadChannels``)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a {len(shape)}-D shape")
    out = []
    for n, e in zip(shape, spec):
        if isinstance(e, HeadChannels):
            out.append(e.block(n, mesh))
        elif e is None:
            out.append(n)
        else:
            if n % mesh.axis_size(e):
                raise ValueError(f"{n} does not divide over {e}")
            out.append(n // mesh.axis_size(e))
    return tuple(out)


def shard_tensor(full: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (one entry per dim), a
    tensor of its own (the full one can be freed)."""
    if len(spec) != full.ndim:
        raise ValueError(f"spec {spec} for a {full.ndim}-D tensor")
    out = full
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.axis_size(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n})")
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axes) * size, size)
    return out.clone() if out is not full else full


def ep_axis(ctx, num_experts: int):
    """The axis the expert dim is cut along under ``ctx`` (a
    ``core.dist.DistContext``), or None: its ``moe_ep_axis`` when that axis
    has more than one rank and its size divides ``num_experts`` (the
    reference's ``moe._ep_axis``)."""
    axis = getattr(ctx, "moe_ep_axis", None) if ctx is not None else None
    if not axis:
        return None
    nc = ctx.mesh.axis_size(axis)
    if nc <= 1 or num_experts % nc:
        return None
    return axis


def shard_block(block, ctx):
    """Cut one decoder block to this rank's serving state in place: under
    expert parallelism its expert panels keep this rank's experts only
    (``G / nc`` of them, contiguous, the block the executors own).  Returns
    the block."""
    moe = getattr(block, "moe", None)
    if moe is None:
        return block
    axis = ep_axis(ctx, moe.w_gate.shape[0])
    if axis is None:
        return block
    for name in _EXPERT_PANELS:
        full = getattr(moe, name)
        spec = (axis,) + (None,) * (full.ndim - 1)
        part = shard_tensor(full.detach(), spec, ctx.mesh)
        setattr(moe, name, torch.nn.Parameter(
            part, requires_grad=full.requires_grad))
    return block


def serving_state(model, ctx):
    """A full port model (``models.model.DenseLM``) cut to this rank's
    serving state under ``ctx`` in place: every block through
    ``shard_block``; the rest stays replicated.  Returns the model."""
    for block in model.layers:
        shard_block(block, ctx)
    return model


# ---------------------------------------------------------------------------
# The training layout: every parameter cut to this rank's block
# ---------------------------------------------------------------------------

# Leaves the model reads in fp32 whatever the compute dtype (norm scales,
# the SSM's decay, skip and dt bias): ``gathered`` leaves their dtype.
_FP32_LEAVES = {"ln1", "ln2", "ln_cross", "ln", "norm", "final_norm",
                "enc_norm", "q_norm", "k_norm", "A_log", "D_skip",
                "dt_bias"}
# (name, ndim) -> the dim the local compute reads cut over ``model``.
_TP_DIM = {("wq", 2): 1, ("wk", 2): 1, ("wv", 2): 1, ("w_gate", 2): 1,
           ("w_up", 2): 1, ("wo", 2): 0, ("w_down", 2): 0}


def param_path(name: str) -> tuple[list[str], bool]:
    """A port parameter name (``layers.3.attn.wq``) -> its path in the
    reference tree (``["layers", "attn", "wq"]``) and whether the tree
    stacks it on a leading layer axis."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return [parts[0], *parts[2:]], True
    return parts, False


def named_specs(named: dict, mesh: Mesh, *, zero_stage: int = 3,
                moe_ep: bool = False, moe_ep_axis: str = "dp") -> dict:
    """{parameter name: spec} for a port model's (full) parameters: the
    reference's ``param_specs`` of the stacked tree, the layer axis
    dropped."""
    out = {}
    for name, t in named.items():
        path, stacked = param_path(name)
        shape = ((1,) if stacked else ()) + tuple(t.shape)
        spec = _normal(_param_spec(path, shape, mesh, zero_stage, moe_ep,
                                   moe_ep_axis))
        out[name] = spec[1:] if stacked else spec
    return out


def shard_params(model: torch.nn.Module, specs: dict, mesh: Mesh) -> None:
    """Cut every parameter of ``model`` (full, as ``init_params`` draws it)
    to this rank's block under ``specs`` ({name: spec}) in place, each new
    parameter tagged with its spec (``mesh_spec``)."""
    for name, full in list(model.named_parameters()):
        *mods, leaf = name.split(".")
        owner = model.get_submodule(".".join(mods)) if mods else model
        spec = specs[name]
        block = torch.nn.Parameter(shard_tensor(full.detach(), spec, mesh),
                                   requires_grad=full.requires_grad)
        block.mesh_spec = spec
        setattr(owner, leaf, block)


def full_tensor(block: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``block`` is this rank's part under
    ``spec`` (every rank of the mesh calls it; no gradient)."""
    out = block.detach()
    for dim, axes in enumerate(spec):
        if axes is not None:
            out = collective.raw_all_gather(out, mesh, axes, dim)
    return out


def load_blocks(named: dict, tree: dict, specs: dict, mesh: Mesh) -> None:
    """Copy into each block of ``named`` its part of the leaf of the same
    name in a whole tree of the reference's layout (``to_numpy_tree``)."""
    with torch.no_grad():
        for name, dst in named.items():
            path, stacked = param_path(name)
            node = tree
            for key in path:
                node = node[key]
            src = np.asarray(node[int(name.split(".")[1])] if stacked
                             else node)
            dst.copy_(shard_tensor(torch.as_tensor(src), specs[name], mesh))


def refine_spec(param_spec: tuple, opt_spec: tuple) -> tuple:
    """Where a moment block of ``opt_spec`` lies within its parameter's
    block of ``param_spec``: the spec, over the parameter block, of the
    cuts ``opt_spec`` adds (ZeRO-1: the moments cut over the data axes
    where the parameters are not).  Raises where ``opt_spec`` does not
    cut every dim the parameter spec cuts, the same way."""
    if len(param_spec) != len(opt_spec):
        raise ValueError(f"opt spec {opt_spec} for a parameter spec "
                         f"{param_spec}")
    out = []
    for p_e, o_e in zip(param_spec, opt_spec):
        if p_e is not None and p_e != o_e:
            raise ValueError(f"opt spec {opt_spec} does not refine the "
                             f"parameter spec {param_spec}")
        out.append(o_e if p_e is None else None)
    return tuple(out)


def shard_opt_state(opt: dict, params: dict, specs: dict,
                    mesh: Mesh) -> dict:
    """The moments of ``opt`` (drawn like the parameter blocks of
    ``params``) cut to this rank's blocks under ``specs`` ({name: opt
    spec}) in place, each tagged with its spec (``mesh_spec``), which
    ``optim.adamw.apply_updates`` reads.  Returns ``opt``."""
    for key in ("m", "v"):
        for name, t in opt[key].items():
            extra = refine_spec(params[name].mesh_spec, specs[name])
            block = (shard_tensor(t, extra, mesh) if any(
                e is not None for e in extra) else t)
            block.mesh_spec = specs[name]
            opt[key][name] = block
    return opt


def replicas(spec: tuple, mesh: Mesh) -> int:
    """How many ranks of the mesh hold the same block under ``spec``."""
    return mesh.size // math.prod(mesh.axis_size(a) for a in spec
                                  if a is not None)


def cut_batch(cfg, batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global host batch (numpy leaves) under
    ``batch_specs``: contiguous blocks of the batch dim over the data axes,
    bitwise the global rows."""
    specs = batch_specs(cfg, batch, mesh)
    out = {}
    for k, v in batch.items():
        axes = specs[k][0]
        if axes is None:
            out[k] = v
            continue
        n = mesh.axis_size(axes)
        rows = v.shape[0] // n
        i = mesh.axis_index(axes)
        out[k] = v[i * rows:(i + 1) * rows]
    return out


def _dp_entry(entry, dp: tuple) -> bool:
    if entry is None or entry == "model":
        return False
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    if set(axes) != set(dp):
        raise ValueError(f"a spec entry {entry} that is not the data axes "
                         f"{dp} or 'model'")
    return True


def _kept_dims(name: str, p: torch.Tensor, spec: tuple, ctx) -> set[int]:
    """The dims the local compute reads cut (see the module docstring)."""
    keep = set()
    if (name, p.ndim) in _TP_DIM:
        keep.add(_TP_DIM[(name, p.ndim)])
    if name == "out_proj" and ctx.head_shard > 1:
        keep.add(0)
    if p.ndim == 3 and spec[0] is not None:    # expert-parallel panels
        keep.add(0)
    return keep


def _materialize(p: torch.Tensor, name: str, ctx, dtype) -> torch.Tensor:
    spec, mesh = p.mesh_spec, ctx.mesh
    dt = p.dtype if name in _FP32_LEAVES else dtype
    keep = _kept_dims(name, p, spec, ctx)
    dp_dims = [d for d, e in enumerate(spec) if _dp_entry(e, ctx.dp_axes)]
    gather_dp = [d for d in dp_dims if d not in keep]
    if len(gather_dp) > 1:
        raise ValueError(f"{name}: spec {spec} cuts two dims over the data "
                         "axes")
    if ctx.dp_size > 1 and len(gather_dp) == len(dp_dims):
        # Every rank of the data axes holds a part of the gradient: the
        # ZeRO gather (or, uncut, the fp32 sum of the gradient alone).
        w = collective.zero_gather(p, mesh, ctx.dp_axes,
                                   gather_dp[0] if gather_dp else None, dt)
    else:
        w = p.to(dt).view_as(p)        # a tensor of its own, never p
    cut = False
    for dim, entry in enumerate(spec):
        if entry == "model":
            if dim in keep:
                cut = True
            else:
                w = collective.gather(w, mesh, ctx.model_axis, dim)
    if cut:
        w.model_cut = (mesh, ctx.model_axis)
    return w


@contextlib.contextmanager
def gathered(*modules, dtype: torch.dtype, recurse: bool = True):
    """Under a ``DistContext`` with ``sharded_params``: each tagged block of
    ``modules`` (their submodules too unless ``recurse`` is False) read as
    the local compute needs it (the module docstring), in ``dtype`` (the
    fp32 leaves in theirs), until the block ends; the parameters
    themselves stay this rank's blocks.  Called inside a rematerialised
    block, the gathers run again in its recompute.  Elsewhere a no-op."""
    ctx = current_dist()
    if ctx is None or not ctx.sharded_params:
        yield
        return
    shadowed = []
    try:
        for mod in modules:
            if mod is None:
                continue
            subs = mod.modules() if recurse else (mod,)
            for m in subs:
                for name, p in m.named_parameters(recurse=False):
                    if (getattr(p, "mesh_spec", None) is None
                            or name in m.__dict__):
                        continue
                    # An instance attribute shadows the registered
                    # parameter for attribute reads until it is deleted.
                    m.__dict__[name] = _materialize(p, name, ctx, dtype)
                    shadowed.append((m, name))
        yield
    finally:
        for m, name in shadowed:
            del m.__dict__[name]
