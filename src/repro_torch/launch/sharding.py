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
(``models.model.make_cache``), everything else replicated.  The
tensor-parallel / ZeRO-3 layout of the dense panels under ``param_specs``,
which the reference's GSPMD applies, comes with the trainer on a mesh
(ROADMAP Queue 1 item 10, slice 15).
"""
from __future__ import annotations

import math

import torch

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


def param_specs(params_shape, mesh: Mesh, *, zero_stage: int = 3,
                moe_ep: bool = False, moe_ep_axis: str = "dp"):
    """Spec tree matching a parameter (or optimizer-state) tree.
    ``zero_stage`` 3: weights 2-D sharded (TP x ZeRO); 0 / 1: TP only.
    ``moe_ep``: the expert panels sharded on their EXPERT dim over
    ``moe_ep_axis`` ("dp" or a mesh axis), the other weight dim
    ZeRO-sharded over the data axes when EP rides the model axis."""
    def walk(names, leaf):
        shape = tuple(leaf.shape)
        spec = _leaf_spec(names, shape, mesh)
        name = names[-1]
        stacked = int(any(p in _STACKED for p in names[:-1]))
        dims = shape[stacked:]
        dp = dp_axes(mesh) or None
        if moe_ep and name in (_COL | _ROW) and len(dims) == 3:
            e_ax = dp if moe_ep_axis == "dp" else "model"
            other = dp if moe_ep_axis != "dp" else None
            parts = [None] * stacked + [_maybe(dims[0], e_ax, mesh),
                                        None, None]
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
    return _map_with_path(walk, params_shape)


def batch_specs(cfg, batch_shape, mesh: Mesh):
    dp = dp_axes(mesh) or None

    def per_leaf(names, leaf):
        shape = tuple(leaf.shape)
        return (_maybe(shape[0], dp, mesh),) + (None,) * (len(shape) - 1)

    return _map_with_path(per_leaf, batch_shape)


def cache_specs(cfg, cache_shape, mesh: Mesh):
    """Decode / prefill cache: B over dp, the sequence over model
    (K-parallel), the SSM head dim over model."""
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
