"""Mixture-of-Experts MLP with the reference's two dispatch modes, forward.

``"capacity"`` -- Switch-style static capacity: each routed (token, k) copy
takes the next row of its expert's capacity bucket; copies beyond the
capacity are DROPPED and empty rows stay zero.  The (E, C, D) buffer runs
through the grouped fused SwiGLU pair (``grouped_swiglu``, one launch) and
the grouped down projection (``grouped_matmul``).  Every expert costs C
rows whatever the router did.

``"ragged"`` -- capacity-free: the copies sort by expert (stable), the
per-expert counts become the device prefix sums ``group_offsets``, and the
expert GEMMs run as ragged grouped GEMMs (``ragged_swiglu`` then
``ragged_matmul``) over exactly the routed rows.  Nothing is dropped or
padded, and no count ever comes to the host: the kernels read the offsets
on the device.

The router is the paper's T1 shape (tokens x d_model x E, E = 8..16) and
runs through ``project`` on the dense kernel.  Both modes return
(y, aux) with the Switch-style load-balancing loss, which serving ignores
and training adds to the loss.  Both are differentiable as in the
reference: gradients flow through the gate weights, the capacity scatter
(an ``index_add_`` into a fresh buffer) and the ragged un-sort; the
routing itself (top-k indices, ranks, offsets) carries none.
``quant`` (a ``core.quant`` mode) quantizes the ragged experts as the
reference does: the gate and up products are two quantized
``ragged_matmul`` calls to fp32 (the fused pair would need two dequant
vectors in one flush), silu(g) * u runs in fp32 and is cast to the compute
type, then the quantized down product.  The router is never quantized.
Capacity dispatch with ``quant`` raises, as in the reference.

Expert parallelism: under a ``core.dist.DistContext`` whose
``moe_ep_axis`` has more than one rank and divides the expert count
(``launch.sharding.ep_axis``, the reference's ``_ep_axis``), the ragged
mode runs its expert GEMMs through ``ep_ragged_moe``: the routing (router,
sort, offsets) is computed alike on every rank, the tokens go to the rank
that owns their expert and back, and the block's panels are this rank's
G / nc experts (``launch.sharding.shard_block`` cut them).  As in the
reference, that branch comes first and runs the panels unquantized: the
exchange moves activations, not panels, so a ``quant`` mode buys it no
wire bytes.  Capacity dispatch runs expert-parallel where the rows are cut
over the data axes, or over an axis whose ranks hold the same rows
(below).

On a training mesh whose data axes cut the rows (``DistContext.rows_cut``)
the aux loss is the global batch's: it is E · Σ mean(probs) · mean(top-1
one-hot), a product of means, so the per-expert sums and the row count are
summed over the data axes before it is formed (each rank adds the global
aux to its loss; the sums' gradient reaches each rank's own rows).  Under
expert parallelism over the data axes the executor needs the global row
array: the ranks' rows are gathered, routed and sorted alike on every
rank, and each rank keeps its own rows of the result (the result's
cotangent summed over the axes first, the executor's convention).
Capacity dispatch there sizes the buckets from the global batch, as
GSPMD's one program does: the capacity is that of the T x dp global rows,
each rank ranks its own (token, k) copies within their expert in token
order, and the exclusive prefix over the data axes of every rank's
per-expert counts (one all-gather of E integers) offsets those ranks, so
each rank keeps and drops exactly the copies the one-device run keeps and
drops.  A rank fills the global (E x C, D) buffer with its own copies;
the buffer is reduce-scattered over the data axes by expert, each rank
runs the grouped pair and down product on its E / dp experts (its own
panels under ``moe_ep``, else its experts of the gathered panels), and
the results are all-gathered for every rank to read its copies back
(``_capacity_experts_cut``; where the data axes outnumber the experts,
the buffer is cut by capacity slot instead and each rank runs every
expert on its share of the slots, ``_capacity_slots_cut``).  Bytes a layer's
forward moves, per rank: the E integers, the reduce-scatter of E x C x D
in the compute type and the all-gather of the same; the backward moves
those two again (under gloo the reduce-scatter is an all-reduce of the
whole buffer and a narrow).

Under expert parallelism over an axis whose ranks hold the same rows (the
model axis, the reference's ``moe_ep_axis="model"``; or the data axes
when they do not cut the rows) the executor takes the rows as they are:
the ragged mode calls ``ep_ragged_moe`` on them, and capacity dispatch
runs the rank's experts on its slice of the capacity buffer and gathers
the results over the axis (``_capacity_experts_local``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.dist import current_dist
from ..core.gemm import (collective, ep_ragged_moe, grouped_matmul,
                         grouped_swiglu, plan_moe_dispatch, project,
                         ragged_matmul, ragged_swiglu)
from ..core.quant import QuantConfig
from ..core.quant import resolve as resolve_quant
from ..launch.sharding import ep_axis
from .attention import param


class MoEParams(nn.Module):
    """router (D, E), w_gate / w_up (E, D, F) and w_down (E, F, D)."""

    def __init__(self, router, w_gate, w_up, w_down, *,
                 requires_grad: bool = False):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = (
            param(t, requires_grad) for t in (router, w_gate, w_up, w_down))


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, *, dtype: torch.dtype,
                    device: torch.device,
                    requires_grad: bool = False) -> MoEParams:
    """The reference's initialisation (normal, He-scaled by fan-in), drawn
    from ``gen`` in fp32 and cast to ``dtype``."""
    s_in, s_out = (2.0 / d_model) ** 0.5, (2.0 / d_ff) ** 0.5

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    e = num_experts
    return MoEParams(normal((d_model, e), s_in),
                     normal((e, d_model, d_ff), s_in),
                     normal((e, d_model, d_ff), s_in),
                     normal((e, d_ff, d_model), s_out),
                     requires_grad=requires_grad)


def capacity(num_tokens: int, num_experts: int, top_k: int,
             capacity_factor: float = 1.25,
             dtype: torch.dtype = torch.float32) -> int:
    """Per-expert capacity: the planner's ``plan_moe_dispatch`` rows over
    the experts, so the dispatch buffer and the priced rows share one
    rounding rule (the reference's, which decides which tokens drop)."""
    rows = plan_moe_dispatch(num_tokens, num_experts, top_k, 0, 0,
                             dispatch="capacity",
                             capacity_factor=capacity_factor,
                             elt_bytes=dtype.itemsize).rows
    return rows // num_experts


def _router(x: torch.Tensor, router: torch.Tensor, num_experts: int,
            top_k: int):
    """Router head: the T1 GEMM to fp32 logits, top-k gates (normalised
    when top_k > 1) and the Switch-style aux loss (over the global batch
    when the data axes cut the rows).  -> (gate_w (T, K) fp32, gate_idx
    (T, K), aux)."""
    logits = project(x, router.to(x.dtype), out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)
    if top_k > 1:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    experts = torch.arange(num_experts, device=x.device)
    ctx = current_dist()
    if ctx is not None and ctx.rows_cut:
        hits = (gate_idx[:, :1] == experts).to(torch.float32).sum(dim=0)
        rows = torch.full((1,), float(x.shape[0]), device=x.device)
        stats = collective.reduce_sum(
            torch.cat([probs.sum(dim=0), hits, rows]), ctx.mesh, ctx.dp_axes)
        p_sum, hits, rows = stats.split([num_experts, num_experts, 1])
        aux = num_experts * torch.sum((p_sum / rows) * (hits / rows).detach())
        return gate_w, gate_idx, aux
    ce = (gate_idx[:, :1] == experts).to(torch.float32).mean(dim=0)
    aux = num_experts * torch.sum(probs.mean(dim=0) * ce)
    return gate_w, gate_idx, aux


def moe_mlp(x: torch.Tensor, params: MoEParams, *, num_experts: int,
            top_k: int, capacity_factor: float = 1.25,
            compute_dtype=torch.bfloat16, dispatch: str = "capacity",
            quant: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, D) flat tokens -> (output (T, D), aux loss).  See the module
    docstring for the dispatch modes; ``capacity_factor`` is ignored by
    "ragged".  ``quant`` quantizes the ragged experts' panels; with
    capacity dispatch it raises."""
    qcfg = resolve_quant(quant)
    if dispatch == "ragged":
        return _moe_mlp_ragged(x, params, num_experts=num_experts,
                               top_k=top_k, compute_dtype=compute_dtype,
                               qcfg=qcfg)
    if dispatch != "capacity":
        raise ValueError(f"unknown moe dispatch: {dispatch}")
    if not qcfg.is_noop:
        raise ValueError("quantized experts require the ragged (zero-drop) "
                         f"dispatch, not {dispatch!r}")
    ctx = current_dist()
    cut = ctx is not None and ctx.rows_cut
    t, d = x.shape
    e = num_experts
    # The capacity of the global batch: on a mesh that cuts the rows, the
    # ranks' rows are equal blocks of it (``launch.sharding.cut_batch``).
    c = capacity(t * (ctx.dp_size if cut else 1), e, top_k, capacity_factor,
                 dtype=compute_dtype)
    xc = x.to(compute_dtype)
    gate_w, gate_idx, aux = _router(xc, params.router, e, top_k)

    slot, keep = capacity_slots(gate_idx, e, c)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    buf = torch.zeros((e * c + 1, d), dtype=compute_dtype, device=x.device)
    buf.index_add_(0, slot, xc[tok_idx])
    buf = buf[:e * c]

    wg, wu, wd = (w.to(compute_dtype)
                  for w in (params.w_gate, params.w_up, params.w_down))
    ep = ep_axis(ctx, e)
    if ep is not None and not (cut and _is_data(ep, ctx)):
        y_buf = _capacity_experts_local(buf, wg, wu, wd, ctx.mesh, ep, e, c)
    elif cut:
        y_buf = _capacity_experts_cut(buf, wg, wu, wd, ctx, e, c)
    else:
        h = grouped_swiglu(buf.view(e, c, d), wg, wu)           # (E, C, F)
        y_buf = grouped_matmul(h, wd).reshape(e * c, d)
    y_tok = y_buf[slot.clamp(max=e * c - 1)]
    y_tok = y_tok * (keep * gate_w.reshape(-1))[:, None].to(compute_dtype)
    y = y_tok.reshape(t, top_k, d).sum(dim=1)
    return y.to(x.dtype), aux


def capacity_slots(gate_idx: torch.Tensor, num_experts: int,
                   cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) copy's row of the (E x cap) capacity buffer and
    whether it is kept: its rank within its expert in token order, kept
    below ``cap``.  A dropped copy's row is E x cap, a spare row past the
    buffer (the reference scatters it out of bounds in "drop" mode); kept
    rows are unique.  On a mesh whose data axes cut the rows the rank is
    over the global batch: the copies of the ranks before this one come
    first in each expert.  -> (slot (T*K,), keep (T*K,))."""
    e = num_experts
    flat_idx = gate_idx.reshape(-1)                             # (T*K,)
    sel = (flat_idx[:, None] == torch.arange(e, device=gate_idx.device)).to(
        torch.int64)
    pos = (torch.cumsum(sel, dim=0) - 1).gather(1, flat_idx[:, None])[:, 0]
    ctx = current_dist()
    if ctx is not None and ctx.rows_cut:
        pos = pos + _rank_offsets(sel.sum(dim=0), ctx)[flat_idx]
    keep = pos < cap
    return torch.where(keep, flat_idx * cap + pos, e * cap), keep


def _rank_offsets(counts: torch.Tensor, ctx) -> torch.Tensor:
    """(E,) copies routed to each expert by the ranks before this one along
    the data axes: the exclusive prefix, in rank order, of every rank's
    per-expert counts."""
    mesh, axes = ctx.mesh, ctx.dp_axes
    every = collective.raw_all_gather(counts[None], mesh, axes)  # (nc, E)
    return every[:mesh.axis_index(axes)].sum(dim=0)


def _is_data(axis, ctx) -> bool:
    """Whether ``axis`` is the context's data axes."""
    return ctx.mesh.axes(axis) == tuple(ctx.dp_axes)


def _capacity_experts_local(buf: torch.Tensor, wg: torch.Tensor,
                            wu: torch.Tensor, wd: torch.Tensor, mesh, axis,
                            e: int, c: int) -> torch.Tensor:
    """The expert GEMMs of a capacity buffer under expert parallelism over
    an axis whose ranks hold the same rows: each rank runs its E / nc
    experts (its panels) on their slots of the buffer, and the results
    are gathered over the axis (the gather's backward keeps the rank's
    block of a cotangent every rank of the axis computed alike).  -> (E *
    C, D)."""
    nc, s = mesh.axis_size(axis), mesh.axis_index(axis)
    e_l, d = e // nc, buf.shape[-1]
    mine = buf.view(e, c, d)[s * e_l:(s + 1) * e_l]
    h = grouped_swiglu(mine, wg, wu)                            # (E_l, C, F)
    y_l = grouped_matmul(h, wd).reshape(e_l * c, d)
    return collective.gather(y_l, mesh, axis, 0)


def _capacity_experts_cut(buf: torch.Tensor, wg: torch.Tensor,
                          wu: torch.Tensor, wd: torch.Tensor, ctx, e: int,
                          c: int) -> torch.Tensor:
    """The expert GEMMs of a capacity buffer whose rows this rank filled
    with its own copies only (the other ranks' slots zero).  Each rank of
    the data axes runs E / nc experts: the buffer is reduce-scattered over
    the axes by expert (every slot was written by one rank, so the sum only
    merges them), the rank's experts run the grouped pair and down
    product, and the (E / nc, C, D) results are all-gathered.  The
    gradient takes the transposes: the results' cotangents summed over
    the axes in fp32 and cut to the rank's experts, the buffer's gathered.
    The panels are this rank's experts under expert parallelism over the
    data axes (``moe_ep``), else the whole gathered panels, read at the
    rank's experts.  -> (E * C, D), every rank's copies' rows."""
    mesh, axes = ctx.mesh, ctx.dp_axes
    nc, s = ctx.dp_size, mesh.axis_index(axes)
    if e % nc:
        return _capacity_slots_cut(buf, wg, wu, wd, ctx, e, c)
    ep = ep_axis(ctx, e)
    e_l, d = e // nc, buf.shape[-1]
    if ep is None:
        wg, wu, wd = (w[s * e_l:(s + 1) * e_l] for w in (wg, wu, wd))
    mine = collective.reduce_scatter(buf, mesh, axes).view(e_l, c, d)
    h = grouped_swiglu(mine, wg, wu)                            # (E_l, C, F)
    y_l = grouped_matmul(h, wd).reshape(e_l * c, d)
    return collective.zero_gather(y_l, mesh, axes, 0, y_l.dtype)


def _moe_mlp_ragged(x: torch.Tensor, params: MoEParams, *, num_experts: int,
                    top_k: int, compute_dtype=torch.bfloat16,
                    qcfg: QuantConfig = QuantConfig()):
    """Capacity-free dispatch: stable sort by expert, device prefix sums,
    the fused ragged gate/up pair (or, quantized, the two quantized
    products and silu(g) * u; or, expert-parallel, ``ep_ragged_moe`` on
    this rank's panels) and the ragged down projection, then the
    gate-weighted un-sort (a scatter-add; with top-1 it has no duplicate
    rows, so it is deterministic)."""
    t, d = x.shape
    e = num_experts
    xc = x.to(compute_dtype)
    gate_w, gate_idx, aux = _router(xc, params.router, e, top_k)
    ctx = current_dist()
    axis = ep_axis(ctx, e)
    if axis is not None and ctx.rows_cut and _is_data(axis, ctx):
        return _ep_rows_cut(xc, gate_w, gate_idx, params, ctx, axis,
                            top_k, compute_dtype).to(x.dtype), aux

    flat_idx = gate_idx.reshape(-1)                             # (T*K,)
    order = torch.argsort(flat_idx, stable=True)
    tok_sorted = order // top_k
    counts = torch.zeros(e, dtype=torch.int32, device=x.device).index_add_(
        0, flat_idx, torch.ones_like(flat_idx, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, dim=0, dtype=torch.int32)])

    xs = xc[tok_sorted]                                         # (T*K, D)
    wg, wu, wd = (w.to(compute_dtype)
                  for w in (params.w_gate, params.w_up, params.w_down))
    if axis is not None:
        # Fused EP pipeline: one d_model-wide exchange each way; the
        # (rows, d_ff) hidden stays on the rank owning the expert.
        ys = ep_ragged_moe(xs, wg, wu, wd, offsets, mesh=ctx.mesh, axis=axis)
    elif qcfg.is_noop:
        h = ragged_swiglu(xs, wg, wu, offsets)                  # (T*K, F)
        ys = ragged_matmul(h, wd, offsets)
    else:
        hg = ragged_matmul(xs, wg, offsets, quant=qcfg,
                           out_dtype=torch.float32)
        hu = ragged_matmul(xs, wu, offsets, quant=qcfg,
                           out_dtype=torch.float32)
        h = (hg * torch.sigmoid(hg) * hu).to(compute_dtype)
        ys = ragged_matmul(h, wd, offsets, quant=qcfg)

    gw_sorted = gate_w.reshape(-1)[order]
    y = torch.zeros((t, d), dtype=compute_dtype, device=x.device).index_add_(
        0, tok_sorted, ys * gw_sorted[:, None].to(compute_dtype))
    return y.to(x.dtype), aux


def _capacity_slots_cut(buf: torch.Tensor, wg: torch.Tensor,
                        wu: torch.Tensor, wd: torch.Tensor, ctx, e: int,
                        c: int) -> torch.Tensor:
    """``_capacity_experts_cut`` where the data axes outnumber the experts
    (mixtral's 8 over 16 ranks): the buffer is cut over the axes by
    capacity slot instead of by expert -- each expert's C slots padded to a
    multiple of nc, rank s reduce-scattered the s-th block of every
    expert's slots -- each rank runs every expert (the whole panels) on
    its blocks, and the results are all-gathered back in place."""
    mesh, axes = ctx.mesh, ctx.dp_axes
    nc, d = ctx.dp_size, buf.shape[-1]
    cb = -(-c // nc)
    cube = torch.nn.functional.pad(buf.view(e, c, d), (0, 0, 0, cb * nc - c))
    cube = cube.view(e, nc, cb, d).transpose(0, 1).reshape(nc * e * cb, d)
    mine = collective.reduce_scatter(cube, mesh, axes).view(e, cb, d)
    y_l = grouped_matmul(grouped_swiglu(mine, wg, wu), wd)     # (E, Cb, D)
    y = collective.zero_gather(y_l.reshape(e * cb, d), mesh, axes, 0,
                               y_l.dtype)
    y = y.view(nc, e, cb, d).transpose(0, 1).reshape(e, nc * cb, d)
    return y[:, :c].reshape(e * c, d)


def _ep_rows_cut(xc: torch.Tensor, gate_w: torch.Tensor,
                 gate_idx: torch.Tensor, params: MoEParams, ctx, axis,
                 top_k: int, compute_dtype) -> torch.Tensor:
    """Expert parallelism over the data axes, each rank with its own rows:
    the rows and their routing gathered over the axes (rank order, so the
    global row array is the global batch's), sorted by expert alike on
    every rank, ``ep_ragged_moe`` on this rank's panels, and this rank's
    copies read back and gate-weighted (summed over k in k order; with
    top-1, the one-device un-sort exactly)."""
    mesh = ctx.mesh
    e = params.router.shape[-1]
    t = xc.shape[0]
    x_g = collective.gather(xc, mesh, axis)                     # (T_g, D)
    idx_g = collective.raw_all_gather(gate_idx, mesh, axis)     # (T_g, K)
    flat = idx_g.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(e, dtype=torch.int32, device=xc.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, dim=0, dtype=torch.int32)])
    wg, wu, wd = (w.to(compute_dtype)
                  for w in (params.w_gate, params.w_up, params.w_down))
    ys = ep_ragged_moe(x_g[order // top_k], wg, wu, wd, offsets, mesh=mesh,
                       axis=axis)
    ys = collective.replicate(ys, mesh, axis)
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), device=order.device)
    r0 = mesh.axis_index(axis) * t * top_k
    mine = ys[where[r0:r0 + t * top_k]].reshape(t, top_k, -1)
    w = gate_w.to(compute_dtype)
    y = mine[:, 0] * w[:, :1]
    for k in range(1, top_k):
        y = y + mine[:, k] * w[:, k:k + 1]
    return y
