"""Framework-wide GEMM entry points, forward and backward.

Every contraction of the model stack routes through ``matmul`` / ``project``
(dense), ``matmul_swiglu`` / ``project_swiglu`` (the fused MLP pair),
``batched_matmul`` / ``grouped_matmul`` / ``grouped_swiglu`` (grouped: the
attention products and the capacity-MoE experts) or ``ragged_matmul`` /
``ragged_swiglu`` (the capacity-free MoE experts): the shape is classified
(paper Sec. III-A), the CMR tuner picks the tile (Sec. IV-C), and the call
goes to the ftIMM kernel wrapper.  The tensor's device picks the engine
there: a CPU tensor takes the plain version (``kernels.ftimm.ref``), a CUDA
tensor takes the planned kernel or raises.  A plan served from the
measured plan store may run the epilogue as separate passes over the
output (``fuse`` False) or split K (``nsplit`` > 1, ``ftimm_gemm_splitk``):
that is the plan's choice, made before the launch.

The fallback ladder has one rung, fused -> unfused: when the fused-epilogue
dense launch or a one-launch SwiGLU pair fails (a real error or one
injected at the ``kernel_fused`` chaos site), the call runs the unfused
spelling instead -- the identity kernel to fp32 and the epilogue's passes
(``Epilogue.decompose``), or the pair's two planned products to fp32 and
then ``silu(a) * b``.  It launches the same hand-written kernels on a CUDA
tensor, never the plain version.  Each such serving is counted in
``tuner.plan_mode_stats()["degraded"]`` as ``<family>:fused->unfused`` and
warned once per (family, rung).  Every other planned launch probes the
``kernel`` site and fails the call when it fails: unlike the reference,
there is no kernel -> plain-version rung.

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

``quant=`` (``matmul`` / ``project`` / ``ragged_matmul``; a
``core.quant`` mode or ``QuantConfig``) is the reference's managed
quantized GEMM: the call quantizes its operands itself (the weight per
channel -- per expert and channel for the ragged panels --, the
activations per tensor for "int8" and the fp8 modes; w4 round-trips its
nibble packing), runs the 1-byte product with the combined dequant vector
in the epilogue's ``scale_vec`` and then the caller's tail, and its
backward is straight-through: dA against the quantized panel with the
weight scale folded into the cotangent (dense), or dX against the
dequantized panels (ragged); dW is the full-precision product.  The
weights are quantized on every call, as in the reference's serving.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from .. import quant as _quant
from ...kernels.ftimm import ops as _ops
from ...kernels.ftimm.epilogue import IDENTITY, Epilogue
from ...kernels.ftimm.kernel import (gemm_operands_ok, grouped_operands,
                                     mkn, ragged_dw_operands_mn,
                                     ragged_operands, row_groups,
                                     swiglu_operands)
from ...runtime import chaos as _chaos
from .tuner import (note_degraded, note_epilogue, note_plan_use,
                    plan_batched_gemm, plan_gemm, plan_ragged_gemm)

F32 = torch.float32

# (family, rung) pairs already warned about; ``tuner.clear_plan_cache``
# empties it with the counters.
_WARNED_RUNGS: set = set()


def _degraded(family: str, rung: str, err: BaseException) -> None:
    """Count one serving of a ladder rung and warn at its first use."""
    note_degraded(family, rung)
    key = (family, rung)
    if key not in _WARNED_RUNGS:
        _WARNED_RUNGS.add(key)
        warnings.warn(
            f"gemm dispatch degraded: {family} {rung} "
            f"({type(err).__name__}: {err})", RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# remat="dots": the non-batched products are saved, not recomputed
# ---------------------------------------------------------------------------

class DotsStash:
    """The outputs of one checkpointed block's non-batched products
    (``matmul`` / ``project``, fused epilogues included, and the dense
    SwiGLU pair): the reference's ``dots_with_no_batch_dims_saveable``.
    The block's first run records each differentiable product's output;
    every later run (the checkpoint's recompute in the backward) takes
    them back in call order instead of launching, so only the norms, RoPE,
    the elementwise ops and the batched / grouped / ragged products are
    recomputed.  The ftIMM entry points are ``autograd.Function``s over
    ``ctypes`` calls, which ``torch.utils.checkpoint``'s selective policies
    cannot see; this stash does their job."""

    def __init__(self):
        self.outputs: list[torch.Tensor] = []
        self.cursor: int | None = None      # None: recording
        self._runs = 0

    @contextlib.contextmanager
    def active(self):
        """Install the stash for one run of the block."""
        self.cursor = None if self._runs == 0 else 0
        self._runs += 1
        _STASHES.append(self)
        try:
            yield self
        finally:
            _STASHES.pop()

    def run(self, apply):
        """``apply(saved)`` with ``saved`` None (record its output) or the
        output this call gave in the first run (replay)."""
        if self.cursor is None:
            out = apply(None)
            self.outputs.append(out.detach())
            return out
        saved = self.outputs[self.cursor]
        self.cursor += 1
        return apply(saved)


_STASHES: list[DotsStash] = []


def _stashed(apply):
    """A differentiable non-batched product through the innermost active
    ``DotsStash``, or launched when none is."""
    return _STASHES[-1].run(apply) if _STASHES else apply(None)


def _replayed(saved: torch.Tensor, *operands) -> torch.Tensor:
    """The saved output, checked against what the replayed call would
    give: a recompute that strays from the recorded order raises."""
    lead = operands[0].shape[:-1]
    if saved.shape[:-1] != lead:
        raise RuntimeError(
            f"remat='dots' replay out of order: saved {tuple(saved.shape)} "
            f"for operands {[tuple(t.shape) for t in operands]}")
    return saved.detach()


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

def _fp8(a, b) -> bool:
    """Both operands 1-byte floats: the FMA body sums them with fp32 FMAs,
    not the int8 path's integer multiply-adds (the planner's ``fp8``)."""
    return all(t.element_size() == 1 and t.dtype.is_floating_point
               for t in (a, b))


def _run_dense(a, b, trans: str, out_dtype, epi: Epilogue = IDENTITY,
               bias=None, residual=None, scale=None) -> torch.Tensor:
    """Plan one dense GEMM (its body too: the planner sees the operand
    widths and whether TMA can read them as laid out) and run it.  A plan
    that declines fusion, or a fused launch that fails (the fused ->
    unfused rung), runs the identity kernel to fp32 and then the tail one
    op at a time (``Epilogue.decompose``), as the tuner timed it."""
    m, k, n = mkn(trans, a.shape, b.shape)
    a_ok, b_ok = gemm_operands_ok(a, b, trans)
    plan = plan_gemm(m, k, n, a.element_size(), out_dtype.itemsize,
                     b_bytes=b.element_size(), a_ok=a_ok, b_ok=b_ok,
                     trans=trans, fp8=_fp8(a, b))
    note_plan_use("dense", plan)
    kw = dict(trans=trans, out_dtype=out_dtype, epilogue=epi, bias=bias,
              residual=residual, scale=scale, **plan.kernel_kwargs())
    if epi.is_identity:
        _chaos.fire("kernel")
        return _ops.gemm(a, b, **kw)
    note_epilogue("dense", plan.fuse)
    if plan.fuse:
        try:
            _chaos.fire("kernel_fused")
            return _ops.gemm(a, b, **kw)
        except Exception as e:
            _degraded("dense", "fused->unfused", e)
    _chaos.fire("kernel")
    return _ops.gemm_unfused(a, b, **kw)


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


def _tail_grads(epi: Epilogue, z, extras, g):
    """(dz, [d_bias, d_residual, d_scale][:len(extras)]) of ``epi.apply(z,
    *extras)`` for the cotangent ``g``, in fp32; each operand's gradient
    in its own dtype, None where the operand is absent."""
    live = [i for i, t in enumerate(extras) if t is not None]
    with torch.enable_grad():
        z_ = z.detach().requires_grad_()
        ins = [t.detach().requires_grad_() if t is not None else None
               for t in extras]
        y = epi.apply(z_, *ins)
        grads = torch.autograd.grad(y, [z_] + [ins[i] for i in live],
                                    g.to(F32))
    d_extras = [None] * len(extras)
    for i, d in zip(live, grads[1:]):
        d_extras[i] = d.to(extras[i].dtype)
    return grads[0], d_extras


class _Matmul(torch.autograd.Function):
    """The reference's ``_pallas_fn`` custom VJP."""

    @staticmethod
    def forward(ctx, a, b, bias, residual, scale, trans, out_dtype, epi,
                saved=None):
        ctx.save_for_backward(a, b, bias, residual, scale)
        ctx.trans, ctx.epi = trans, epi
        if saved is not None:
            return _replayed(saved, a if trans != "tn" else a.T)
        return _run_dense(a, b, trans, out_dtype, epi, bias, residual, scale)

    @staticmethod
    def backward(ctx, g):
        a, b, bias, residual, scale = ctx.saved_tensors
        trans, epi = ctx.trans, ctx.epi
        d_extras = [None, None, None]
        if epi.is_identity:
            dz = g.contiguous()
        else:
            # The epilogue's gradient depends on z only through an
            # activation or the scale vector's own cotangent; otherwise the
            # pre-epilogue product is not rematerialised (any z will do).
            z = (_run_dense(a, b, trans, F32)
                 if epi.activation != "none" or epi.scale_vec else g.to(F32))
            dz, d_extras = _tail_grads(epi, z, (bias, residual, scale), g)
            dz = dz.to(a.dtype)
        need_a, need_b = ctx.needs_input_grad[:2]
        da, db = _dense_grads(a, b, dz, trans, need_a, need_b)
        return (da, db, *d_extras, None, None, None, None)


# The profiler range around the weight quantization of a quantized call
# (``launch.profile_serve`` reports its kernels as a group of their own).
QUANT_RANGE = "ftimm weight quantization"


def _quantize_weight(w: torch.Tensor, qcfg: "_quant.QuantConfig"):
    """(W_q, scale): the panel(s) per channel, w4 through its nibble
    packing (the kernel reads int8, holding what the packed storage
    holds)."""
    with torch.profiler.record_function(QUANT_RANGE):
        w_q, w_scale = _quant.quantize_weights(w, qcfg)
        if qcfg.mode == "w4":
            w_q = _quant.unpack_int4(_quant.pack_int4(w_q))
    return w_q, w_scale


def _quantize_operands(a, b, qcfg: "_quant.QuantConfig"):
    """(A as the kernel reads it, W_q, the weight scale, the combined
    (N,) or (G, N) dequant vector): weight-only modes keep A, the others
    quantize it per tensor."""
    w_q, w_scale = _quantize_weight(b, qcfg)
    if qcfg.weight_only:
        return a, w_q, w_scale, w_scale
    a_q, a_scale = _quant.quantize_activations(a, qcfg)
    return a_q, w_q, w_scale, w_scale * a_scale


def _run_quant(a, b, qcfg, out_dtype, epi: Epilogue, bias, residual):
    """The quantized dense forward: the 1-byte (or mixed) product with the
    dequant vector at the flush, then the caller's tail."""
    a_q, w_q, _, sv = _quantize_operands(a, b, qcfg)
    return _run_dense(a_q, w_q, "nn", out_dtype,
                      dataclasses.replace(epi, scale_vec=True), bias,
                      residual, sv)


class _QuantMatmul(torch.autograd.Function):
    """The reference's ``_quant_fn`` custom VJP: straight-through against
    the dequantized weight.  dA is the planned "nt" product of the
    cotangent, its columns scaled by the weight scale, against W_q (the
    1-byte panel, on ``ftimm_gemm``'s mixed FMA instantiations); dB the
    full-precision T2 product.  With a tail the pre-tail value (the
    dequantized product) is rematerialised for the tail's gradient."""

    @staticmethod
    def forward(ctx, a, b, bias, residual, qcfg, out_dtype, epi,
                saved=None):
        ctx.save_for_backward(a, b, bias, residual)
        ctx.qcfg, ctx.epi = qcfg, epi
        if saved is not None:
            return _replayed(saved, a)
        return _run_quant(a, b, qcfg, out_dtype, epi, bias, residual)

    @staticmethod
    def backward(ctx, g):
        a, b, bias, residual = ctx.saved_tensors
        epi = ctx.epi
        a_q, w_q, w_scale, sv = _quantize_operands(a, b, ctx.qcfg)
        d_extras = [None, None]
        if epi.is_identity:
            dz = g.to(F32)
        else:
            z = _run_dense(a_q, w_q, "nn", F32, Epilogue(scale_vec=True),
                           scale=sv)
            dz, d_extras = _tail_grads(epi, z, (bias, residual), g)
        need_a, need_b = ctx.needs_input_grad[:2]
        da = db = None
        if need_a:
            da = _run_dense((dz * w_scale.to(F32)).to(a.dtype), w_q, "nt",
                            F32).to(a.dtype)
        if need_b:
            db = _run_dense(a, dz.to(a.dtype), "tn", F32).to(b.dtype)
        return (da, db, *d_extras, None, None, None, None)


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans: str = "nn",
           out_dtype=None, epilogue: Epilogue | None = None,
           bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None,
           scale: torch.Tensor | None = None,
           quant: "_quant.QuantConfig | str | None" = None) -> torch.Tensor:
    """2-D GEMM through the ftIMM planner, fp32 accumulation always.
    ``epilogue`` fuses the elementwise tail into the accumulator flush:
    ``bias`` (N,), ``residual`` (M, N), ``scale`` the (N,) dequant vector;
    all are differentiable.  ``quant`` ("w8" / "w4" / "int8" / "fp8_e4m3"
    / "fp8_e5m2", or a ``QuantConfig``) quantizes the operands in the call
    and runs the quantized product (the module docstring), for ``trans``
    "nn" only and without ``scale``."""
    epi = IDENTITY if epilogue is None else epilogue
    out_dtype = out_dtype or a.dtype
    qcfg = _quant.resolve(quant)
    if not qcfg.is_noop:
        if trans != "nn":
            raise ValueError("quantized matmul is defined for trans='nn' "
                             f"only (got trans={trans!r})")
        if epi.scale_vec or scale is not None:
            raise ValueError(
                "quant= derives its own dequant scale; for manual control "
                "pass pre-quantized operands with epilogue.scale_vec "
                "instead")
        _check_epi(epi, bias, residual, None)
        if _needs_grad(a, b, bias, residual):
            return _stashed(lambda saved: _QuantMatmul.apply(
                a, b, bias, residual, qcfg, out_dtype, epi, saved))
        return _run_quant(a, b, qcfg, out_dtype, epi, bias, residual)
    _check_epi(epi, bias, residual, scale)
    if _needs_grad(a, b, bias, residual, scale):
        return _stashed(lambda saved: _Matmul.apply(
            a, b, bias, residual, scale, trans, out_dtype, epi, saved))
    return _run_dense(a, b, trans, out_dtype, epi, bias, residual, scale)


def project(x: torch.Tensor, w: torch.Tensor, *, trans: str = "nn",
            out_dtype=None, epilogue: Epilogue | None = None,
            bias: torch.Tensor | None = None,
            residual: torch.Tensor | None = None,
            quant: "_quant.QuantConfig | str | None" = None) -> torch.Tensor:
    """(..., D) against a (D, N) weight ("nn") or an (N, D) one ("nt") ->
    (..., N), the leading dims flattened into the paper's M (tokens).
    ``residual`` (..., N) is flattened alongside x; ``quant`` as for
    ``matmul``."""
    lead = x.shape[:-1]
    n = w.shape[-1] if trans == "nn" else w.shape[0]
    res = None if residual is None else residual.reshape(-1, n)
    y = matmul(x.reshape(-1, x.shape[-1]), w, trans=trans,
               out_dtype=out_dtype, epilogue=epilogue, bias=bias,
               residual=res, quant=quant)
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


def _fused_pair(family: str, launch, unfused_product, out_dtype):
    """The one-launch SwiGLU pair ``launch()``, or on its failure (the
    ``kernel_fused`` site or a real error) the fused -> unfused rung: the
    two planned products ``unfused_product(0 | 1)`` to fp32, then
    ``silu(a) * b``."""
    try:
        _chaos.fire("kernel_fused")
        return launch()
    except Exception as e:
        _degraded(family, "fused->unfused", e)
    a, b = unfused_product(0), unfused_product(1)
    return (torch.nn.functional.silu(a) * b).to(out_dtype)


def _run_swiglu(x, wg, wu, out_dtype) -> torch.Tensor:
    """Plan the dense SwiGLU pair (its body from the widths and how TMA
    reads x and both panels) and run it."""
    x_k, w_ok = swiglu_operands(x, wg, wu)
    plan = plan_gemm(x.shape[0], x.shape[1], wg.shape[1], x.element_size(),
                     out_dtype.itemsize, panels=2, b_bytes=wg.element_size(),
                     a_ok=x_k, b_ok=w_ok)
    note_plan_use("dense", plan)
    note_epilogue("dense", True)
    return _fused_pair(
        "dense",
        lambda: _ops.gemm_swiglu(x, wg, wu, bm=plan.bm, bn=plan.bn,
                                 bk=plan.bk, out_dtype=out_dtype,
                                 body=plan.body, kslices=plan.kslices,
                                 dim_order=plan.dim_order),
        lambda i: _run_dense(x, (wg, wu)[i], "nn", F32), out_dtype)


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
    return _fused_pair(
        "batched",
        lambda: _ops.batched_gemm_swiglu(x, wg, wu, bm=plan.bm, bn=plan.bn,
                                         bk=plan.bk, out_dtype=out_dtype,
                                         body=plan.body,
                                         kslices=plan.kslices),
        lambda i: _run_batched(x, (wg, wu)[i], "nn", F32), out_dtype)


class _Swiglu(torch.autograd.Function):
    """The reference's ``_make_swiglu_fn`` custom VJP, dense (``grouped``
    False) or grouped (a 2-D x shared by the groups sums its dX)."""

    @staticmethod
    def forward(ctx, x, wg, wu, out_dtype, grouped, saved=None):
        ctx.save_for_backward(x, wg, wu)
        ctx.grouped = grouped
        if saved is not None:
            return _replayed(saved, x)
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
        return dx, dwg, dwu, None, None, None


def matmul_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  *, out_dtype=None) -> torch.Tensor:
    """Dense fused MLP front half: silu(x @ Wg) * (x @ Wu) in one kernel
    launch.  ``x`` (M, K), panels (K, N)."""
    if x.ndim != 2 or w_gate.shape != w_up.shape:
        raise ValueError(f"swiglu shapes {tuple(x.shape)} x "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)}")
    out_dtype = out_dtype or x.dtype
    if _needs_grad(x, w_gate, w_up):
        return _stashed(lambda saved: _Swiglu.apply(
            x, w_gate, w_up, out_dtype, False, saved))
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
    _chaos.fire("kernel")
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
                bias=None, scale=None) -> torch.Tensor:
    """Plan one ragged grouped GEMM off its distribution signature (its
    body too, from the total rows, the widths and how TMA reads x and the
    panels) and run it.  ``w`` (G, K, N) "nn" or (G, N, K) "nt"; ``bias``
    or ``scale`` (the dequant vector): a (G, N) flush vector."""
    g = w.shape[0]
    k, n = (w.shape[1], w.shape[2]) if trans == "nn" else (w.shape[2],
                                                            w.shape[1])
    x_k, w_ok = ragged_operands(x, w, trans)
    plan = plan_ragged_gemm(g, x.shape[0], k, n, x.element_size(),
                            out_dtype.itemsize, b_bytes=w.element_size(),
                            a_ok=x_k, b_ok=w_ok, trans=trans,
                            fp8=_fp8(x, w))
    note_plan_use("ragged", plan)
    epi = Epilogue(bias=bias is not None, scale_vec=scale is not None)
    if not epi.is_identity:
        note_epilogue("ragged", True)
    _chaos.fire("kernel")
    return _ops.ragged_gemm(x, w, offsets, bm=plan.bm, bn=plan.bn,
                            bk=plan.bk, trans=trans, out_dtype=out_dtype,
                            epilogue=None if epi.is_identity else epi,
                            bias=bias, scale=scale, body=plan.body,
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
    _chaos.fire("kernel")
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


def _run_quant_ragged(x, w, offsets, qcfg, out_dtype) -> torch.Tensor:
    """The quantized ragged forward: per-expert per-channel panels (and
    the per-tensor rows for "int8" / fp8), the (G, N) dequant vector at
    the flush."""
    x_run, w_q, _, sv = _quantize_operands(x, w, qcfg)
    return _run_ragged(x_run, w_q, offsets, "nn", out_dtype, scale=sv)


class _QuantRagged(torch.autograd.Function):
    """The reference's ``_quant_ragged_fn`` custom VJP: straight-through,
    dX the planned "nt" ragged product against the dequantized panels,
    dW the full-precision ragged-K product."""

    @staticmethod
    def forward(ctx, x, w, offsets, qcfg, out_dtype):
        ctx.save_for_backward(x, w, offsets)
        ctx.qcfg = qcfg
        return _run_quant_ragged(x, w, offsets, qcfg, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, offsets = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dy = g.contiguous()
        dx = dw = None
        if need_x:
            w_q, w_scale = _quantize_weight(w, ctx.qcfg)
            w_dq = _quant.dequantize(w_q, w_scale[:, None, :], dtype=x.dtype)
            dx = _run_ragged(dy, w_dq, offsets, "nt", x.dtype)
        if need_w:
            dw = _run_ragged_dw(x, dy, offsets, w.dtype)
        return dx, dw, None, None, None


def ragged_matmul(x: torch.Tensor, w: torch.Tensor,
                  group_offsets: torch.Tensor, *, out_dtype=None,
                  bias: torch.Tensor | None = None,
                  quant: "_quant.QuantConfig | str | None" = None
                  ) -> torch.Tensor:
    """Ragged grouped GEMM through the ftIMM planner; fp32 accumulation.

    ``x`` (T, D) flat rows sorted so each group's rows are contiguous;
    ``group_offsets`` (G+1,) prefix sums on x's device, offsets[0] == 0 and
    offsets[G] == T (every row owned: capacity-free, nothing dropped); ``w``
    (G, D, F) per-group panels.  Returns (T, F).  ``bias`` (G, F) adds a
    per-expert bias at the flush.  ``quant`` quantizes the panels per
    expert and channel in the call (the module docstring); it takes no
    bias."""
    out_dtype = out_dtype or x.dtype
    qcfg = _quant.resolve(quant)
    if not qcfg.is_noop:
        if bias is not None:
            raise ValueError("quantized ragged matmul does not take a bias "
                             "operand; apply it as a separate epilogue")
        if _needs_grad(x, w):
            return _QuantRagged.apply(x, w, group_offsets, qcfg, out_dtype)
        return _run_quant_ragged(x, w, group_offsets, qcfg, out_dtype)
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
    return _fused_pair(
        "ragged",
        lambda: _ops.ragged_gemm_swiglu(x, wg, wu, offsets, bm=plan.bm,
                                        bn=plan.bn, bk=plan.bk,
                                        out_dtype=out_dtype, body=plan.body,
                                        kslices=plan.kslices),
        lambda i: _run_ragged(x, (wg, wu)[i], offsets, "nn", F32), out_dtype)


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
