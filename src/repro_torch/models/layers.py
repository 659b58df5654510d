"""Shared building blocks: norms, projections, rotary embeddings, MLPs.

All dense contractions route through ``core.gemm.project`` so the ftIMM
planner sees every GEMM and the CUDA kernels run them on the card.  Weights
are cast to ``compute_dtype`` at use, as in the reference: a training model
keeps fp32 masters and the cast is part of its graph, while a serving
model's weights already have the compute dtype, where ``Tensor.to``
returns the tensor itself (no copy per step).

Elementwise layer tails fuse into their producing GEMM: ``dense`` takes
optional ``bias`` / ``residual`` / ``activation`` (an ``Epilogue`` applied at
the fp32 accumulator flush), and ``swiglu`` runs its gate/up pair as one
fused kernel launch with the residual add fused into the down projection.

Tensor parallelism (Megatron): a panel that ``launch.sharding.gathered``
left cut over the model axis carries ``model_cut`` (``tp_of``).  The
input of a column panel goes through ``collective.replicate`` (its
gradient summed over the axis), and a row panel's partial product is
summed over the axis in fp32 (``row_parallel``) before the residual is
added -- once, after the sum, not on every rank -- and the result rounded
to the compute dtype: one rounding, as the fused epilogue's.
"""
from __future__ import annotations

import torch

from ..core.dist import current_dist
from ..core.gemm import collective, project, project_swiglu
from ..kernels.ftimm.epilogue import Epilogue


def tp_of(w: torch.Tensor):
    """(mesh, model axis) when ``w`` is this rank's tensor-parallel block,
    else None."""
    return getattr(w, "model_cut", None)


def column_input(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a column panel: every rank reads it whole, and its
    gradient is the sum of the ranks' partial ones."""
    return x if tp is None else collective.replicate(x, *tp)


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp, compute_dtype,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w for a row panel ``w`` cut over the model axis: the fp32
    partial products summed over it, then the residual, then one rounding
    to ``compute_dtype``."""
    part = project(x.to(compute_dtype), w.to(compute_dtype),
                   out_dtype=torch.float32)
    y = collective.reduce_sum(part, *tp)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(compute_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, compute_dtype=torch.bfloat16, *,
          bias: torch.Tensor | None = None,
          residual: torch.Tensor | None = None,
          activation: str = "none", quant: str | None = None) -> torch.Tensor:
    """y = act(x @ w + bias) + residual with fp32 accumulation; the tail,
    when present, is a fused GEMM epilogue.  ``quant`` (a ``core.quant``
    mode) runs the managed quantized GEMM: the panel quantized per channel
    in the call, the dequant at the flush, a straight-through backward."""
    epi = Epilogue(bias=bias is not None, activation=activation,
                   residual=residual is not None)
    return project(
        x.to(compute_dtype), w.to(compute_dtype), out_dtype=compute_dtype,
        epilogue=None if epi.is_identity else epi,
        bias=None if bias is None else bias.to(compute_dtype),
        residual=None if residual is None else residual.to(compute_dtype),
        quant=quant)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with the (1 + scale) gain, cast back to x's dtype.
    Under ``DistContext(rms_bf16=True)`` the variance is reduced in fp32
    and the normalization stays in x's dtype, as the reference's: the
    inverse root rounded to x's dtype, then ``x * inv * (1 + scale)``."""
    ctx = current_dist()
    if ctx is not None and ctx.rms_bf16:
        var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                         keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * (1.0 + scale.to(x.dtype))
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, compute_dtype=torch.bfloat16,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x)) [+ residual], the gate/up
    pair as one fused launch and the residual add in the down projection's
    epilogue (tensor-parallel on cut panels: ``row_parallel``)."""
    tp = tp_of(w_down)
    h = project_swiglu(column_input(x, tp).to(compute_dtype),
                       w_gate.to(compute_dtype), w_up.to(compute_dtype),
                       out_dtype=compute_dtype)
    if tp is not None:
        return row_parallel(h, w_down, tp, compute_dtype, residual)
    return dense(h, w_down, compute_dtype, residual=residual)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    angles = positions[..., None].to(torch.float32) * freq   # (..., S, half)
    angles = angles[..., None, :]                            # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    return table.to(compute_dtype)[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor, vocab_size: int,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits = x @ E^T over the (padded) vocab table; padded slots masked.
    The GEMM runs "nt" against the (V, D) table itself, so no transposed
    copy of the table is ever made."""
    logits = project(x.to(compute_dtype), table.to(compute_dtype), trans="nt",
                     out_dtype=torch.float32)
    pad = logits.shape[-1] - vocab_size
    if pad > 0:
        mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits
