"""Framework-wide GEMM entry points (forward).

Every contraction of the model stack routes through ``matmul`` / ``project``
(dense), ``matmul_swiglu`` / ``project_swiglu`` (the fused MLP pair),
``batched_matmul`` / ``grouped_matmul`` / ``grouped_swiglu`` (grouped: the
attention products and the capacity-MoE experts) or ``ragged_matmul`` /
``ragged_swiglu`` (the capacity-free MoE experts): the shape is classified
(paper Sec. III-A),
the CMR tuner picks the tile (Sec. IV-C), and the call goes to the ftIMM
kernel wrapper.  The tensor's device picks the engine there: a CPU tensor
takes the plain version (``kernels.ftimm.ref``), a CUDA tensor takes the
planned kernel or raises.  There is no fallback ladder: a kernel that fails
on the card fails the call.
"""
from __future__ import annotations

import torch

from ...kernels.ftimm import ops as _ops
from ...kernels.ftimm.epilogue import IDENTITY, Epilogue
from ...kernels.ftimm.kernel import mkn
from .tuner import (note_epilogue, note_plan_use, plan_batched_gemm,
                    plan_gemm, plan_ragged_gemm)


def _check_epi(epi: Epilogue, bias, residual, scale) -> None:
    for flag, operand, name in ((epi.bias, bias, "bias"),
                                (epi.residual, residual, "residual"),
                                (epi.scale_vec, scale, "scale")):
        if flag != (operand is not None):
            raise ValueError(
                f"epilogue.{name}={flag} but {name} operand "
                f"{'missing' if operand is None else 'given'}")


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans: str = "nn",
           out_dtype=None, epilogue: Epilogue | None = None,
           bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None,
           scale: torch.Tensor | None = None) -> torch.Tensor:
    """2-D GEMM through the ftIMM planner, fp32 accumulation always.
    ``epilogue`` fuses the elementwise tail into the accumulator flush:
    ``bias`` (N,), ``residual`` (M, N), ``scale`` the (N,) dequant vector."""
    epi = IDENTITY if epilogue is None else epilogue
    out_dtype = out_dtype or a.dtype
    _check_epi(epi, bias, residual, scale)
    m, k, n = mkn(trans, a.shape, b.shape)
    plan = plan_gemm(m, k, n, a.element_size(), out_dtype.itemsize)
    note_plan_use("dense", plan)
    if not epi.is_identity:
        note_epilogue("dense", True)
    return _ops.gemm(a, b, trans=trans, out_dtype=out_dtype, epilogue=epi,
                     bias=bias, residual=residual, scale=scale,
                     **plan.kernel_kwargs())


def project(x: torch.Tensor, w: torch.Tensor, *, trans: str = "nn",
            out_dtype=None, epilogue: Epilogue | None = None,
            bias: torch.Tensor | None = None,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """(..., D) against a (D, N) weight ("nn") or an (N, D) one ("nt") ->
    (..., N), the leading dims flattened into the paper's M (tokens).
    ``residual`` (..., N) is flattened alongside x."""
    lead = x.shape[:-1]
    n = w.shape[-1] if trans == "nn" else w.shape[0]
    res = None if residual is None else residual.reshape(-1, n)
    y = matmul(x.reshape(-1, x.shape[-1]), w, trans=trans,
               out_dtype=out_dtype, epilogue=epilogue, bias=bias,
               residual=res)
    return y.reshape(*lead, n)


def matmul_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  *, out_dtype=None) -> torch.Tensor:
    """Dense fused MLP front half: silu(x @ Wg) * (x @ Wu) in one kernel
    launch.  ``x`` (M, K), panels (K, N)."""
    if x.ndim != 2 or w_gate.shape != w_up.shape:
        raise ValueError(f"swiglu shapes {tuple(x.shape)} x "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)}")
    out_dtype = out_dtype or x.dtype
    plan = plan_gemm(x.shape[0], x.shape[1], w_gate.shape[1],
                     x.element_size(), out_dtype.itemsize, panels=2)
    note_plan_use("dense", plan)
    note_epilogue("dense", True)
    return _ops.gemm_swiglu(x, w_gate, w_up, bm=plan.bm, bn=plan.bn,
                            bk=plan.bk, out_dtype=out_dtype)


def project_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   *, out_dtype=None) -> torch.Tensor:
    """(..., D) fused SwiGLU front half with the leading dims flattened."""
    lead = x.shape[:-1]
    y = matmul_swiglu(x.reshape(-1, x.shape[-1]), w_gate, w_up,
                      out_dtype=out_dtype)
    return y.reshape(*lead, w_gate.shape[-1])


def batched_matmul(a: torch.Tensor, b: torch.Tensor, *, trans: str = "nn",
                   out_dtype=None,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Batched GEMM (G, M, K) @ (G, K, N) -> (G, M, N) through the ftIMM
    planner, fp32 accumulation always.  Either operand may be 2-D (shared
    across the batch).  ``bias`` (N,) shared or (G, N) per group is added at
    the flush (trans "nn" only, as in the reference)."""
    if a.ndim != 3 and b.ndim != 3:
        raise ValueError(f"batched GEMM needs a 3-D operand: "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if bias is not None and trans != "nn":
        raise ValueError("batched bias epilogue is defined for trans='nn' "
                         f"only (got trans={trans!r})")
    out_dtype = out_dtype or a.dtype
    m, k, n = mkn(trans, a.shape[-2:], b.shape[-2:])
    shared = "a" if a.ndim == 2 else ("b" if b.ndim == 2 else "none")
    g = b.shape[0] if shared == "a" else a.shape[0]
    plan = plan_batched_gemm(g, m, k, n, a.element_size(), out_dtype.itemsize,
                             shared)
    note_plan_use("batched", plan)
    epi = IDENTITY if bias is None else Epilogue(bias=True)
    if bias is not None:
        note_epilogue("batched", True)
    return _ops.batched_gemm(a, b, trans=trans, out_dtype=out_dtype,
                             epilogue=epi, bias=bias, **plan.kernel_kwargs())


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, trans: str = "nn",
                   out_dtype=None) -> torch.Tensor:
    """Grouped GEMM of the MoE expert projections, (E, C, D) @ (E, D, F) ->
    (E, C, F).  The engine of ``batched_matmul``; a separate entry point so
    call sites read as what they are (experts, not batches)."""
    return batched_matmul(x, w, trans=trans, out_dtype=out_dtype)


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   *, out_dtype=None) -> torch.Tensor:
    """Grouped fused MoE front half: silu(x_g @ Wg_g) * (x_g @ Wu_g) per
    group in one launch.  ``x`` (G, M, K) or (M, K) shared, panels
    (G, K, N); returns (G, M, N)."""
    if x.ndim not in (2, 3) or w_gate.ndim != 3 or w_gate.shape != w_up.shape:
        raise ValueError(f"grouped swiglu shapes {tuple(x.shape)} x "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)}")
    out_dtype = out_dtype or x.dtype
    g, k, n = w_gate.shape
    plan = plan_batched_gemm(g, x.shape[-2], k, n, x.element_size(),
                             out_dtype.itemsize,
                             "a" if x.ndim == 2 else "none", panels=2)
    note_plan_use("batched", plan)
    note_epilogue("batched", True)
    return _ops.batched_gemm_swiglu(x, w_gate, w_up, bm=plan.bm, bn=plan.bn,
                                    bk=plan.bk, out_dtype=out_dtype)


def ragged_matmul(x: torch.Tensor, w: torch.Tensor,
                  group_offsets: torch.Tensor, *, out_dtype=None,
                  bias: torch.Tensor | None = None,
                  quant: str | None = None) -> torch.Tensor:
    """Ragged grouped GEMM through the ftIMM planner; fp32 accumulation.

    ``x`` (T, D) flat rows sorted so each group's rows are contiguous;
    ``group_offsets`` (G+1,) prefix sums on x's device, offsets[0] == 0 and
    offsets[G] == T (every row owned: capacity-free, nothing dropped); ``w``
    (G, D, F) per-group panels.  Returns (T, F).  ``bias`` (G, F) adds a
    per-expert bias at the flush.  Quantized panels (``quant``) are not
    ported yet and raise."""
    if quant not in (None, "none"):
        raise NotImplementedError(
            f"quant={quant!r}: quantized expert panels come with "
            "quantization (int8 / fp8 / mixed kernels are not built yet)")
    out_dtype = out_dtype or x.dtype
    g, k, n = w.shape
    plan = plan_ragged_gemm(g, x.shape[0], k, n, x.element_size(),
                            out_dtype.itemsize)
    note_plan_use("ragged", plan)
    epi = None if bias is None else Epilogue(bias=True)
    if bias is not None:
        note_epilogue("ragged", True)
    return _ops.ragged_gemm(x, w, group_offsets, bm=plan.bm, bn=plan.bn,
                            bk=plan.bk, out_dtype=out_dtype, epilogue=epi,
                            bias=bias)


def ragged_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  group_offsets: torch.Tensor, *,
                  out_dtype=None) -> torch.Tensor:
    """Fused ragged MoE front half: silu(x @ Wg_g) * (x @ Wu_g) per group in
    one launch (same contract as ``ragged_matmul``)."""
    out_dtype = out_dtype or x.dtype
    g, k, n = w_gate.shape
    plan = plan_ragged_gemm(g, x.shape[0], k, n, x.element_size(),
                            out_dtype.itemsize, panels=2)
    note_plan_use("ragged", plan)
    note_epilogue("ragged", True)
    return _ops.ragged_gemm_swiglu(x, w_gate, w_up, group_offsets,
                                   bm=plan.bm, bn=plan.bn, bk=plan.bk,
                                   out_dtype=out_dtype)
