"""Framework-wide GEMM entry points, forward and backward.

Every contraction of the model stack routes through ``matmul`` / ``project``
(dense), ``matmul_swiglu`` / ``project_swiglu`` (the fused MLP pair),
``batched_matmul`` / ``grouped_matmul`` / ``grouped_swiglu`` (grouped: the
attention products and the capacity-MoE experts) or ``ragged_matmul`` /
``ragged_swiglu`` (the capacity-free MoE experts): the shape is classified
(paper Sec. III-A), the CMR tuner picks the tile (Sec. IV-C), and the call
goes to the ftIMM kernel wrapper.  The tensor's device picks the engine
there: a CPU tensor takes the plain version (``kernels.ftimm.ref``), a CUDA
tensor takes the planned kernel or raises.  There is no fallback ladder: a
kernel that fails on the card fails the call.  A plan served from the
measured plan store may run the epilogue as separate passes over the
output (``fuse`` False) or split K (``nsplit`` > 1, ``ftimm_gemm_splitk``):
that is the plan's choice, made before the launch.

When an operand requires grad, each entry point runs as a
``torch.autograd.Function`` that matches the reference's custom VJP: the
backward products are planned ftIMM GEMMs too -- dX is the "nt" product
against the same panels, dW the T2 product (``tn``; per group for the
grouped GEMM; the ragged-K ``ftimm_gemm_ragged_dw`` for the ragged one).
A fused epilogue's cotangents come from the epilogue's own gradient; the
fp32 pre-epilogue product is rematerialised when that gradient depends on
it (an activation or a scale vector), and the fused SwiGLU pairs
rematerialise both fp32 pre-activations.  Cotangents are cast where the
reference casts them (an epilogue's and a SwiGLU pair's pre-activation
cotangent, to the operand type) and nowhere else: an fp32 cotangent of a
bf16 product with fp32 output (the logits, the router) enters its dX / dW
products in fp32, on the kernels' mixed bf16 x fp32 instantiations.  Group
offsets get no gradient.
"""
from __future__ import annotations

import torch

from ...kernels.ftimm import ops as _ops
from ...kernels.ftimm.epilogue import IDENTITY, Epilogue
from ...kernels.ftimm.kernel import (gemm_operands_ok, grouped_operands,
                                     mkn, ragged_dw_operands_mn,
                                     ragged_operands, row_groups,
                                     swiglu_operands)
from .tuner import (note_epilogue, note_plan_use, plan_batched_gemm,
                    plan_gemm, plan_ragged_gemm)

F32 = torch.float32


def _check_epi(epi: Epilogue, bias, residual, scale) -> None:
    for flag, operand, name in ((epi.bias, bias, "bias"),
                                (epi.residual, residual, "residual"),
                                (epi.scale_vec, scale, "scale")):
        if flag != (operand is not None):
            raise ValueError(
                f"epilogue.{name}={flag} but {name} operand "
                f"{'missing' if operand is None else 'given'}")


def _needs_grad(*tensors) -> bool:
    """Whether the call must record a backward (else the planned forward
    runs bare, as in serving)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def _run_dense(a, b, trans: str, out_dtype, epi: Epilogue = IDENTITY,
               bias=None, residual=None, scale=None) -> torch.Tensor:
    """Plan one dense GEMM (its body too: the planner sees the operand
    widths and whether TMA can read them as laid out) and run it.  A plan
    that declines fusion runs the identity kernel to fp32 and then the
    tail one op at a time (``Epilogue.decompose``), as the tuner timed
    it."""
    m, k, n = mkn(trans, a.shape, b.shape)
    a_ok, b_ok = gemm_operands_ok(a, b, trans)
    plan = plan_gemm(m, k, n, a.element_size(), out_dtype.itemsize,
                     b_bytes=b.element_size(), a_ok=a_ok, b_ok=b_ok,
                     trans=trans)
    note_plan_use("dense", plan)
    if not epi.is_identity:
        note_epilogue("dense", plan.fuse)
    gemm = _ops.gemm if plan.fuse or epi.is_identity else _ops.gemm_unfused
    return gemm(a, b, trans=trans, out_dtype=out_dtype, epilogue=epi,
                bias=bias, residual=residual, scale=scale,
                **plan.kernel_kwargs())


def _dense_grads(a, b, dz, trans: str, need_a: bool, need_b: bool):
    """(dA, dB) of op(A) . op(B) for the cotangent ``dz``, each a planned
    GEMM: dX as "nt", dW as the T2 "tn"."""
    da = db = None
    if trans == "nn":              # y = a @ b
        da = _run_dense(dz, b, "nt", a.dtype) if need_a else None
        db = _run_dense(a, dz, "tn", b.dtype) if need_b else None
    elif trans == "tn":            # y = a.T @ b, a: (K, M)
        da = _run_dense(b, dz, "nt", a.dtype) if need_a else None
        db = _run_dense(a, dz, "nn", b.dtype) if need_b else None
    else:                          # y = a @ b.T, b: (N, K)
        da = _run_dense(dz, b, "nn", a.dtype) if need_a else None
        db = _run_dense(dz, a, "tn", b.dtype) if need_b else None
    return da, db


class _Matmul(torch.autograd.Function):
    """The reference's ``_pallas_fn`` custom VJP."""

    @staticmethod
    def forward(ctx, a, b, bias, residual, scale, trans, out_dtype, epi):
        ctx.save_for_backward(a, b, bias, residual, scale)
        ctx.trans, ctx.epi = trans, epi
        return _run_dense(a, b, trans, out_dtype, epi, bias, residual, scale)

    @staticmethod
    def backward(ctx, g):
        a, b, bias, residual, scale = ctx.saved_tensors
        trans, epi = ctx.trans, ctx.epi
        extras = (bias, residual, scale)
        d_extras = [None, None, None]
        if epi.is_identity:
            dz = g.contiguous()
        else:
            g32 = g.to(F32)
            # The epilogue's gradient depends on z only through an
            # activation or the scale vector's own cotangent; otherwise the
            # pre-epilogue product is not rematerialised (any z will do).
            z = (_run_dense(a, b, trans, F32)
                 if epi.activation != "none" or epi.scale_vec else g32)
            live = [i for i, t in enumerate(extras) if t is not None]
            with torch.enable_grad():
                z_ = z.detach().requires_grad_()
                ins = [t.detach().requires_grad_() if t is not None else None
                       for t in extras]
                y = epi.apply(z_, bias=ins[0], residual=ins[1], scale=ins[2])
                grads = torch.autograd.grad(y, [z_] + [ins[i] for i in live],
                                            g32)
            dz = grads[0].to(a.dtype)
            for i, d in zip(live, grads[1:]):
                d_extras[i] = d.to(extras[i].dtype)
        need_a, need_b = ctx.needs_input_grad[:2]
        da, db = _dense_grads(a, b, dz, trans, need_a, need_b)
        return (da, db, *d_extras, None, None, None)


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans: str = "nn",
           out_dtype=None, epilogue: Epilogue | None = None,
           bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None,
           scale: torch.Tensor | None = None) -> torch.Tensor:
    """2-D GEMM through the ftIMM planner, fp32 accumulation always.
    ``epilogue`` fuses the elementwise tail into the accumulator flush:
    ``bias`` (N,), ``residual`` (M, N), ``scale`` the (N,) dequant vector;
    all are differentiable."""
    epi = IDENTITY if epilogue is None else epilogue
    out_dtype = out_dtype or a.dtype
    _check_epi(epi, bias, residual, scale)
    if _needs_grad(a, b, bias, residual, scale):
        return _Matmul.apply(a, b, bias, residual, scale, trans, out_dtype,
                             epi)
    return _run_dense(a, b, trans, out_dtype, epi, bias, residual, scale)


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


# ---------------------------------------------------------------------------
# Fused SwiGLU pairs (dense, grouped and ragged share the backward)
# ---------------------------------------------------------------------------

def _swiglu_bwd(x, wg, wu, a, b, g, nt, dw):
    """(dx, dwg, dwu) of silu(x Wg) * (x Wu) from the rematerialised fp32
    pre-activations ``a``, ``b`` and the output cotangent ``g``; ``nt(p,
    w)`` is the planned fp32 dX product p . w^T, ``dw(p, dtype)`` the
    planned T2 weight gradient x^T . p."""
    sg = torch.sigmoid(a)
    g32 = g.to(F32)
    da = (g32 * b * sg * (1.0 + a * (1.0 - sg))).to(x.dtype)
    db = (g32 * a * sg).to(x.dtype)
    dx = (nt(da, wg) + nt(db, wu)).to(x.dtype)
    return dx, dw(da, wg.dtype), dw(db, wu.dtype)


def _run_swiglu(x, wg, wu, out_dtype) -> torch.Tensor:
    """Plan the dense SwiGLU pair (its body from the widths and how TMA
    reads x and both panels) and run it."""
    x_k, w_ok = swiglu_operands(x, wg, wu)
    plan = plan_gemm(x.shape[0], x.shape[1], wg.shape[1], x.element_size(),
                     out_dtype.itemsize, panels=2, b_bytes=wg.element_size(),
                     a_ok=x_k, b_ok=w_ok)
    note_plan_use("dense", plan)
    note_epilogue("dense", True)
    return _ops.gemm_swiglu(x, wg, wu, bm=plan.bm, bn=plan.bn, bk=plan.bk,
                            out_dtype=out_dtype, body=plan.body,
                            kslices=plan.kslices, dim_order=plan.dim_order)


def _run_grouped_swiglu(x, wg, wu, out_dtype) -> torch.Tensor:
    """Plan the grouped SwiGLU pair (its body from the widths and how TMA
    reads x and both panels) and run it."""
    g, k, n = wg.shape
    a_major, g_ok = grouped_operands(x, wg, "nn")
    plan = plan_batched_gemm(g, x.shape[-2], k, n, x.element_size(),
                             out_dtype.itemsize,
                             "a" if x.ndim == 2 else "none", panels=2,
                             b_bytes=wg.element_size(), a_major=a_major,
                             b_ok=g_ok and grouped_operands(x, wu, "nn")[1])
    note_plan_use("batched", plan)
    note_epilogue("batched", True)
    return _ops.batched_gemm_swiglu(x, wg, wu, bm=plan.bm, bn=plan.bn,
                                    bk=plan.bk, out_dtype=out_dtype,
                                    body=plan.body, kslices=plan.kslices)


class _Swiglu(torch.autograd.Function):
    """The reference's ``_make_swiglu_fn`` custom VJP, dense (``grouped``
    False) or grouped (a 2-D x shared by the groups sums its dX)."""

    @staticmethod
    def forward(ctx, x, wg, wu, out_dtype, grouped):
        ctx.save_for_backward(x, wg, wu)
        ctx.grouped = grouped
        run = _run_grouped_swiglu if grouped else _run_swiglu
        return run(x, wg, wu, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, wg, wu = ctx.saved_tensors
        run = _run_batched if ctx.grouped else _run_dense
        a = run(x, wg, "nn", F32)
        b = run(x, wu, "nn", F32)
        dx, dwg, dwu = _swiglu_bwd(
            x, wg, wu, a, b, g, lambda p, w: run(p, w, "nt", F32),
            lambda p, dt: run(x, p, "tn", dt))
        if ctx.grouped and x.ndim == 2:
            dx = dx.to(F32).sum(dim=0).to(x.dtype)
        return dx, dwg, dwu, None, None


def matmul_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  *, out_dtype=None) -> torch.Tensor:
    """Dense fused MLP front half: silu(x @ Wg) * (x @ Wu) in one kernel
    launch.  ``x`` (M, K), panels (K, N)."""
    if x.ndim != 2 or w_gate.shape != w_up.shape:
        raise ValueError(f"swiglu shapes {tuple(x.shape)} x "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)}")
    out_dtype = out_dtype or x.dtype
    if _needs_grad(x, w_gate, w_up):
        return _Swiglu.apply(x, w_gate, w_up, out_dtype, False)
    return _run_swiglu(x, w_gate, w_up, out_dtype)


def project_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   *, out_dtype=None) -> torch.Tensor:
    """(..., D) fused SwiGLU front half with the leading dims flattened."""
    lead = x.shape[:-1]
    y = matmul_swiglu(x.reshape(-1, x.shape[-1]), w_gate, w_up,
                      out_dtype=out_dtype)
    return y.reshape(*lead, w_gate.shape[-1])


# ---------------------------------------------------------------------------
# Batched / grouped
# ---------------------------------------------------------------------------

def _run_batched(a, b, trans: str, out_dtype, bias=None) -> torch.Tensor:
    """Plan one batched / grouped GEMM (its body too: the planner sees the
    operand widths and how TMA can read them) and run it (``bias``: the
    "nn" flush vector, (N,) or (G, N))."""
    m, k, n = mkn(trans, a.shape[-2:], b.shape[-2:])
    shared = "a" if a.ndim == 2 else ("b" if b.ndim == 2 else "none")
    g = b.shape[0] if shared == "a" else a.shape[0]
    a_major, b_ok = grouped_operands(a, b, trans)
    plan = plan_batched_gemm(g, m, k, n, a.element_size(), out_dtype.itemsize,
                             shared, b_bytes=b.element_size(),
                             a_major=a_major, b_ok=b_ok, trans=trans)
    note_plan_use("batched", plan)
    epi = IDENTITY if bias is None else Epilogue(bias=True)
    if bias is not None:
        note_epilogue("batched", True)
    return _ops.batched_gemm(a, b, bm=plan.bm, bn=plan.bn, bk=plan.bk,
                             dim_order=plan.dim_order, trans=trans,
                             out_dtype=out_dtype, epilogue=epi, bias=bias,
                             body=plan.body, kslices=plan.kslices)


class _Batched(torch.autograd.Function):
    """The reference's ``_batched_fn`` / ``_batched_bias_fn`` custom VJPs:
    every backward product is a planned grouped GEMM, except a shared 2-D
    weight's dW, which is one flat T2 GEMM over all G x M rows."""

    @staticmethod
    def forward(ctx, a, b, bias, trans, out_dtype):
        ctx.save_for_backward(a, b, bias)
        ctx.trans = trans
        return _run_batched(a, b, trans, out_dtype, bias)

    @staticmethod
    def backward(ctx, g):
        a, b, bias = ctx.saved_tensors
        trans = ctx.trans
        need_a, need_b, need_bias = ctx.needs_input_grad[:3]
        dy = g.contiguous()
        # A shared 2-D operand sums its per-group gradients, in fp32.
        a_dt = F32 if a.ndim == 2 else a.dtype
        b_dt = F32 if b.ndim == 2 else b.dtype
        da = db = dbias = None
        if trans == "nn":          # y_g = a_g @ b_g
            da = _run_batched(dy, b, "nt", a_dt) if need_a else None
            if need_b and b.ndim == 2:
                db = _run_dense(a.reshape(-1, a.shape[-1]),
                                dy.reshape(-1, dy.shape[-1]), "tn", b.dtype)
            elif need_b:
                db = _run_batched(a, dy, "tn", b_dt)
        elif trans == "tn":        # y_g = a_g.T @ b_g, a: (G, K, M)
            da = _run_batched(b, dy, "nt", a_dt) if need_a else None
            db = _run_batched(a, dy, "nn", b_dt) if need_b else None
        else:                      # y_g = a_g @ b_g.T, b: (G, N, K)
            da = _run_batched(dy, b, "nn", a_dt) if need_a else None
            db = _run_batched(dy, a, "tn", b_dt) if need_b else None
        if da is not None and a.ndim == 2:
            da = da.sum(dim=0).to(a.dtype)
        if db is not None and b.ndim == 2 and db.ndim == 3:
            db = db.sum(dim=0).to(b.dtype)
        if need_bias:
            g32 = g.to(F32)
            dbias = (g32.sum(dim=(0, 1)) if bias.ndim == 1
                     else g32.sum(dim=1)).to(bias.dtype)
        return da, db, dbias, None, None


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
    if _needs_grad(a, b, bias):
        return _Batched.apply(a, b, bias, trans, out_dtype)
    return _run_batched(a, b, trans, out_dtype, bias)


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
    if _needs_grad(x, w_gate, w_up):
        return _Swiglu.apply(x, w_gate, w_up, out_dtype, True)
    return _run_grouped_swiglu(x, w_gate, w_up, out_dtype)


# ---------------------------------------------------------------------------
# Ragged (capacity-free) grouped GEMM
# ---------------------------------------------------------------------------

def _run_ragged(x, w, offsets, trans: str, out_dtype,
                bias=None) -> torch.Tensor:
    """Plan one ragged grouped GEMM off its distribution signature (its
    body too, from the total rows, the widths and how TMA reads x and the
    panels) and run it.  ``w`` (G, K, N) "nn" or (G, N, K) "nt"; ``bias``
    (G, N)."""
    g = w.shape[0]
    k, n = (w.shape[1], w.shape[2]) if trans == "nn" else (w.shape[2],
                                                            w.shape[1])
    x_k, w_ok = ragged_operands(x, w, trans)
    plan = plan_ragged_gemm(g, x.shape[0], k, n, x.element_size(),
                            out_dtype.itemsize, b_bytes=w.element_size(),
                            a_ok=x_k, b_ok=w_ok, trans=trans)
    note_plan_use("ragged", plan)
    epi = None if bias is None else Epilogue(bias=True)
    if bias is not None:
        note_epilogue("ragged", True)
    return _ops.ragged_gemm(x, w, offsets, bm=plan.bm, bn=plan.bn,
                            bk=plan.bk, trans=trans, out_dtype=out_dtype,
                            epilogue=epi, bias=bias, body=plan.body,
                            kslices=plan.kslices)


def _run_ragged_dw(x, dy, offsets, out_dtype) -> torch.Tensor:
    """The ragged T2 backward dW, planned with ragged="k" (the ragged rows
    are the contraction; each group owns a D x F panel)."""
    g = offsets.shape[0] - 1
    x_mn, dy_mn = ragged_dw_operands_mn(x, dy)
    plan = plan_ragged_gemm(g, x.shape[0], x.shape[1], dy.shape[1],
                            x.element_size(), out_dtype.itemsize, ragged="k",
                            b_bytes=dy.element_size(), a_ok=x_mn, b_ok=dy_mn)
    note_plan_use("ragged", plan)
    return _ops.ragged_gemm_dw(x, dy, offsets, bm=plan.bm, bn=plan.bn,
                               bk=plan.bk, out_dtype=out_dtype,
                               body=plan.body)


class _Ragged(torch.autograd.Function):
    """The reference's ``_ragged_fn`` / ``_ragged_bias_fn`` custom VJPs: dX
    is the "nt" ragged product against the same panels, dW the ragged-K
    product, d_bias the per-group row sum of the cotangent."""

    @staticmethod
    def forward(ctx, x, w, offsets, bias, out_dtype):
        ctx.save_for_backward(x, w, offsets, bias)
        return _run_ragged(x, w, offsets, "nn", out_dtype, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, offsets, bias = ctx.saved_tensors
        need_x, need_w, _, need_bias = ctx.needs_input_grad[:4]
        dy = g.contiguous()
        dx = _run_ragged(dy, w, offsets, "nt", x.dtype) if need_x else None
        dw = _run_ragged_dw(x, dy, offsets, w.dtype) if need_w else None
        dbias = None
        if need_bias:
            gid, owned = row_groups(offsets, g.shape[0])
            dbias = torch.zeros((bias.shape[0], g.shape[1]), dtype=F32,
                                device=g.device).index_add_(
                0, gid, g.to(F32) * owned[:, None]).to(bias.dtype)
        return dx, dw, None, dbias, None


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
    if _needs_grad(x, w, bias):
        return _Ragged.apply(x, w, group_offsets, bias, out_dtype)
    return _run_ragged(x, w, group_offsets, "nn", out_dtype, bias)


def _run_ragged_swiglu(x, wg, wu, offsets, out_dtype) -> torch.Tensor:
    """Plan the ragged SwiGLU pair off its distribution signature (its body
    from the total rows, the widths and how TMA reads x and both panels)
    and run it."""
    g, k, n = wg.shape
    x_k, g_ok = ragged_operands(x, wg, "nn")
    plan = plan_ragged_gemm(g, x.shape[0], k, n, x.element_size(),
                            out_dtype.itemsize, panels=2,
                            b_bytes=wg.element_size(), a_ok=x_k,
                            b_ok=g_ok and ragged_operands(x, wu, "nn")[1])
    note_plan_use("ragged", plan)
    note_epilogue("ragged", True)
    return _ops.ragged_gemm_swiglu(x, wg, wu, offsets, bm=plan.bm,
                                   bn=plan.bn, bk=plan.bk,
                                   out_dtype=out_dtype, body=plan.body,
                                   kslices=plan.kslices)


class _RaggedSwiglu(torch.autograd.Function):
    """The reference's ``_ragged_swiglu_fn`` custom VJP: remat both fp32
    pre-activations with planned ragged GEMMs, two "nt" dX products and
    two ragged-K dW products."""

    @staticmethod
    def forward(ctx, x, wg, wu, offsets, out_dtype):
        ctx.save_for_backward(x, wg, wu, offsets)
        return _run_ragged_swiglu(x, wg, wu, offsets, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, wg, wu, offsets = ctx.saved_tensors
        a = _run_ragged(x, wg, offsets, "nn", F32)
        b = _run_ragged(x, wu, offsets, "nn", F32)
        dx, dwg, dwu = _swiglu_bwd(
            x, wg, wu, a, b, g,
            lambda p, w: _run_ragged(p, w, offsets, "nt", F32),
            lambda p, dt: _run_ragged_dw(x, p, offsets, dt))
        return dx, dwg, dwu, None, None


def ragged_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  group_offsets: torch.Tensor, *,
                  out_dtype=None) -> torch.Tensor:
    """Fused ragged MoE front half: silu(x @ Wg_g) * (x @ Wu_g) per group in
    one launch (same contract as ``ragged_matmul``)."""
    out_dtype = out_dtype or x.dtype
    if _needs_grad(x, w_gate, w_up):
        return _RaggedSwiglu.apply(x, w_gate, w_up, group_offsets, out_dtype)
    return _run_ragged_swiglu(x, w_gate, w_up, group_offsets, out_dtype)
