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
wire bytes.  Capacity dispatch is not expert-parallel, as in the
reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.dist import current_dist
from ..core.gemm import (ep_ragged_moe, grouped_matmul, grouped_swiglu,
                         plan_moe_dispatch, project, ragged_matmul,
                         ragged_swiglu)
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
    when top_k > 1) and the Switch-style aux loss.  -> (gate_w (T, K) fp32,
    gate_idx (T, K), aux)."""
    logits = project(x, router.to(x.dtype), out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)
    if top_k > 1:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    experts = torch.arange(num_experts, device=x.device)
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
    t, d = x.shape
    e = num_experts
    c = capacity(t, e, top_k, capacity_factor, dtype=compute_dtype)
    xc = x.to(compute_dtype)
    gate_w, gate_idx, aux = _router(xc, params.router, e, top_k)

    # Rank of each (token, k) copy within its expert, in token order.
    flat_idx = gate_idx.reshape(-1)                             # (T*K,)
    sel = (flat_idx[:, None] == torch.arange(e, device=x.device)).to(
        torch.int64)
    pos = (torch.cumsum(sel, dim=0) - 1).gather(1, flat_idx[:, None])[:, 0]
    keep = pos < c
    # Dropped copies go to a spare row e*c past the buffer (the reference
    # scatters them out of bounds in "drop" mode); kept slots are unique.
    slot = torch.where(keep, flat_idx * c + pos, e * c)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    buf = torch.zeros((e * c + 1, d), dtype=compute_dtype, device=x.device)
    buf.index_add_(0, slot, xc[tok_idx])
    buf = buf[:e * c].view(e, c, d)

    h = grouped_swiglu(buf, params.w_gate.to(compute_dtype),
                       params.w_up.to(compute_dtype))            # (E, C, F)
    y_buf = grouped_matmul(h, params.w_down.to(compute_dtype)).reshape(e * c,
                                                                        d)
    y_tok = y_buf[slot.clamp(max=e * c - 1)]
    y_tok = y_tok * (keep * gate_w.reshape(-1))[:, None].to(compute_dtype)
    y = y_tok.reshape(t, top_k, d).sum(dim=1)
    return y.to(x.dtype), aux


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
    ctx = current_dist()
    axis = ep_axis(ctx, e)
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
