"""Measured auto-tuning on the card: the CMR shortlist timed, the winner
remembered, the model calibrated.

ftIMM's third pillar is auto-tuning of block sizes and parallelization
strategies.  The planners (``tuner.plan_*``) take the CMR model's argmin;
this module closes the loop on the card, in the reference's four steps:

  1. **Shortlist**: the planners' own candidate generators
     (``tuner.*_candidates``) enumerate every body, tile, grid order and K
     slice count the call allows; the model ranks them and the top K (the
     analytic argmin first) go to the card.
  2. **Measure**: each candidate runs through the kernel wrappers
     (``kernels.ftimm.ops``) with its own ``kernel_kwargs()``, never through
     the plan store it validates.  On a CUDA device each is timed with
     ``launch.timing.time_ms`` (the stream held behind a sleep kernel,
     CUDA events around calls run back to back) at the shape it serves, on
     operands rotated through more copies than the 50 MB L2 holds, so a
     decode panel is timed as it is served: read from device memory.  On
     the CPU (``device="cpu"``) every candidate runs the plain version: the
     time does not depend on the plan, so the search keeps the analytic
     choice and feeds the calibration.  Candidates that execute the same computation share one
     measurement, and a tie keeps index 0, the analytic plan: a candidate
     replaces it only when it is faster by more than ``TIE`` (the model's
     own tie band, ``tuner._better``), so timing noise does not churn the
     plans.  A candidate that fails to build or launch raises; it is never
     dropped.
  3. **Remember**: the winner goes into the plan store (``plan_store``)
     under the signature's key; the planners serve it as
     ``mode == "cached"``.
  4. **Calibrate**: ``calibrate`` fits the card's achievable fractions of
     its peak rate and bandwidth from (model, measurement) pairs, so shapes
     never measured plan against corrected constants
     (``tuner.effective_spec``).

The entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise where there is no card.  Not ported: the
placed search over a mesh (``num_shards`` > 1), ``calibrate_ici`` and the
end-to-end placed timings (slice 15 of ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ...kernels.ftimm import ops as _ops
from ...kernels.ftimm.epilogue import Epilogue
from ...launch.timing import sleep_ms_per_mcycle, time_ms
from ..device import resolve_device
from . import plan_store, tuner
from .cmr import H100, HopperSpec, PlanEstimate
from .plan_store import Calibration
from .tuner import GemmPlan

DEFAULT_TOP_K = 4
DEFAULT_REPEATS = 20        # calls averaged on the card; CPU: median of
                            # this many
DEFAULT_MAX_ELEMENTS = 1 << 22      # operand-element budget of a CPU
                                    # search (plan-independent plain
                                    # versions); the card times the served
                                    # shape unless the caller passes one
TIE = 0.02          # times within 2 % of the analytic plan's tie with it
F32 = torch.float32


def _dtype(nbytes: int) -> torch.dtype:
    try:
        return {4: torch.float32, 2: torch.bfloat16,
                1: torch.int8}[int(nbytes)]
    except KeyError:
        raise ValueError(
            f"unsupported operand width for measured tuning: {nbytes} bytes "
            "(4 = float32, 2 = bfloat16, 1 = int8)") from None


def _no_placement(num_shards: int) -> None:
    if num_shards > 1:
        raise NotImplementedError(
            "the measured placed search (num_shards > 1) is not ported: "
            "slice 15 of ROADMAP Queue 1 item 10 (the analytic placement, "
            "tuner.plan_*(num_shards=), is)")


@dataclass(frozen=True)
class TuneResult:
    """Outcome of one measured search.

    ``plan`` is the winner for the original dims (``mode == "measured"``).
    Times are seconds of the measured problem, ``measured_dims``: the
    served shape on the card, the shape scaled into the element budget on
    the CPU (or where the caller passes a budget).  ``t_measured <=
    t_analytic`` holds by construction: the analytic argmin is always
    candidate 0.  ``est_measured`` is the model's estimate of the measured
    problem under the winner's plan, in the uncalibrated spec: the
    (prediction, measurement) pair calibration consumes."""
    family: str
    dims: tuple
    measured_dims: tuple
    key: str
    plan: GemmPlan
    t_measured: float
    t_analytic: float
    analytic_plan: GemmPlan
    est_measured: PlanEstimate
    engine: str                     # "cuda": the kernels; "plain": the CPU
    timed: tuple        # ((body, bm, bn, bk, dim_order, kslices, s), ...)
    in_bytes: int = 4
    b_bytes: int | None = None
    device_kind: str = ""

    @property
    def ratio_pred_over_meas(self) -> float:
        return self.est_measured.t_total / max(self.t_measured, 1e-12)


# ---------------------------------------------------------------------------
# Shape scaling: keep the harness inside an element budget by halving the
# largest shrinkable dims (never N: irregularity lives in M / K / G).  The
# card has no default budget: a scaled M or K changes the bodies and K
# slices a shape allows, so a plan is timed at the shape it serves.
# ---------------------------------------------------------------------------

_SCALE_FLOOR = 4096


def _budget(dev: torch.device, max_elements: int | None) -> float:
    if max_elements is not None:
        return max_elements
    return math.inf if dev.type == "cuda" else DEFAULT_MAX_ELEMENTS


def _check_served(dev: torch.device, store: bool, key: str, dims: tuple,
                  mdims: tuple) -> None:
    """A card-measured winner is stored only for the shape it was timed
    at."""
    if store and dev.type == "cuda" and mdims != dims:
        raise ValueError(
            f"{key}: the element budget scales the timed problem to "
            f"{mdims}; a plan timed there is not stored for {dims} "
            "(store=False times it without storing)")


def _scale2(a: int, b: int, budget_check) -> tuple[int, int]:
    """Halve the larger of two shrinkable dims until the budget holds or
    both hit the floor."""
    while not budget_check(a, b):
        if a >= b and a > _SCALE_FLOOR:
            a = max(a // 2, _SCALE_FLOOR)
        elif b > _SCALE_FLOOR:
            b = max(b // 2, _SCALE_FLOOR)
        elif a > _SCALE_FLOOR:
            a = max(a // 2, _SCALE_FLOOR)
        else:
            break
    return a, b


def _scale_dense(m: int, k: int, n: int, budget: int) -> tuple[int, int, int]:
    m, k = _scale2(m, k, lambda a, b: a * b + b * n + a * n <= budget)
    return m, k, n


def _scale_batched(g: int, m: int, k: int, n: int,
                   budget: int) -> tuple[int, int, int, int]:
    per = m * k + k * n + m * n
    while g * per > budget and g > 4:
        g = max(g // 2, 4)
    m, k = _scale2(m, k,
                   lambda a, b: g * (a * b + b * n + a * n) <= budget)
    return g, m, k, n


def _scale_ragged(g: int, total: int, k: int, n: int,
                  budget: int) -> tuple[int, int, int, int]:
    floor_t = max(_SCALE_FLOOR, 2 * g)
    while total * (k + n) + g * k * n > budget and total > floor_t:
        total = max(total // 2, floor_t)
    while total * (k + n) + g * k * n > budget and k > _SCALE_FLOOR:
        k = max(k // 2, _SCALE_FLOOR)
    return g, total, k, n


def _balanced_offsets(g: int, total: int, device) -> torch.Tensor:
    return torch.as_tensor(np.rint(np.linspace(0, total, g + 1)),
                           dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Operands: laid out as the call's flags say, in as many copies as it takes
# to rotate past the L2.
# ---------------------------------------------------------------------------

def _stored(shape: tuple, dtype, gen, ok: bool = True) -> torch.Tensor:
    """Random ``shape`` with unit stride in the last dim; ``ok`` False pads
    the row stride off a multiple of 8 elements, a layout TMA cannot
    read."""
    cols = shape[-1]
    ld = cols if ok else cols + (1 if (cols + 1) % 8 else 3)
    if dtype == torch.int8:     # full-range codes, as quantized operands
        t = torch.randint(-127, 128, (*shape[:-1], ld), generator=gen,
                          device=gen.device, dtype=torch.int32).to(dtype)
    else:
        t = torch.randn((*shape[:-1], ld), generator=gen, device=gen.device,
                        dtype=F32).to(dtype)
    return t[..., :cols]


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _copies(make, nbytes: int, device: torch.device, seed: int) -> list:
    """``make(gen)`` once on the CPU; on the card in enough copies that
    cycling through them reads each from device memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1
    if device.type == "cuda":
        n = min(max(math.ceil(3 * H100.l2_bytes / max(nbytes, 1)), 1), 64)
    return [make(gen) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _sleep_ms() -> float:
    return sleep_ms_per_mcycle()


def _time(fn, inputs: list, repeats: int) -> float:
    """Seconds of one ``fn(*inputs[i])``: device time on the card, host
    time (median) on the CPU."""
    if inputs[0][0].is_cuda:
        return time_ms(fn, inputs, max(repeats, len(inputs)),
                       _sleep_ms()) / 1e3
    return _ops.bench(fn, *inputs[0], repeats=repeats)


def _measure_shortlist(sl, make_runner, inputs, repeats) -> list[float]:
    """Seconds of each shortlisted candidate, memoized on the signature of
    the computation it executes."""
    memo: dict = {}
    times: list[float] = []
    for cand in sl:
        sig, fn = make_runner(cand)
        if sig not in memo:
            memo[sig] = _time(fn, inputs, repeats)
        times.append(memo[sig])
    return times


def _winner(times: list[float]) -> int:
    """Index of the winner.  Ties keep the analytic argmin, always index 0:
    the fastest candidate wins only when it beats it by more than
    ``TIE``."""
    widx = min(range(len(times)), key=lambda i: (times[i], i))
    return 0 if times[widx] >= (1.0 - TIE) * times[0] else widx


def _sig(cuda: bool, c: GemmPlan, m: int, n: int, *extra):
    """What a candidate executes: the plain version on the CPU whatever the
    plan; on the card its body, the tile the FMA body clamps to, grid
    order, K slices and split count."""
    if not cuda:
        return ("plain", *extra)
    tile = (_ops.clamp_tile(m, n, c.bm, c.bn) if c.body == "fma"
            else (c.bm, c.bn, c.bk))
    return (c.body, tile, c.dim_order, c.kslices, c.nsplit, *extra)


# ---------------------------------------------------------------------------
# Per-family runners: (signature, fn) with fn taking one input tuple.
# ---------------------------------------------------------------------------

def _dense_inputs(m, k, n, in_dt, b_dt, *, device, epilogue, panels, a_ok,
                  b_ok, trans, seed):
    def make(gen):
        if panels == 2:
            return (_stored((m, k), in_dt, gen, a_ok),
                    _stored((k, n), b_dt, gen, b_ok),
                    _stored((k, n), b_dt, gen, b_ok))
        a = (_stored((k, m), in_dt, gen, a_ok) if trans == "tn"
             else _stored((m, k), in_dt, gen, a_ok))
        b = (_stored((n, k), b_dt, gen, b_ok) if trans == "nt"
             else _stored((k, n), b_dt, gen, b_ok))
        if epilogue is None:
            return a, b
        vec = lambda dt: torch.randn(n, generator=gen,  # noqa: E731
                                     device=gen.device).to(dt)
        return (a, b, vec(in_dt) if epilogue.bias else None,
                _stored((m, n), in_dt, gen) if epilogue.residual else None,
                vec(F32) if epilogue.scale_vec else None)

    nbytes = (m * k * _size(in_dt) + panels * k * n * _size(b_dt)
              + m * n * 4)
    return _copies(make, nbytes, device, seed)


def _dense_runner(c: GemmPlan, m, n, out_dt, *, cuda, epilogue, panels,
                  trans):
    kw = c.kernel_kwargs()
    if panels == 2:
        return _sig(cuda, c, m, n), (lambda x, wg, wu: _ops.gemm_swiglu(
            x, wg, wu, bm=c.bm, bn=c.bn, bk=c.bk, out_dtype=out_dt,
            body=c.body, kslices=c.kslices, dim_order=c.dim_order))
    if epilogue is None:
        return _sig(cuda, c, m, n), (lambda a, b: _ops.gemm(
            a, b, trans=trans, out_dtype=out_dt, **kw))
    gemm = _ops.gemm if c.fuse else _ops.gemm_unfused
    return _sig(cuda, c, m, n, c.fuse), (
        lambda a, b, bias, res, scale: gemm(
            a, b, trans=trans, out_dtype=out_dt, epilogue=epilogue,
            bias=bias, residual=res, scale=scale, **kw))


def _plan_fields(c: GemmPlan) -> dict:
    return dict(body=c.body, bm=c.bm, bn=c.bn, bk=c.bk,
                dim_order=c.dim_order, kslices=c.kslices)


def _store_result(res: TuneResult) -> None:
    p = res.plan
    rec = {
        "bm": p.bm, "bn": p.bn, "bk": p.bk, "nsplit": p.nsplit,
        "dim_order": p.dim_order, "edge": "masked", "fuse": p.fuse,
        "body": p.body, "kslices": p.kslices,
        "t_measured_us": round(res.t_measured * 1e6, 3),
        "t_analytic_us": round(res.t_analytic * 1e6, 3),
        "t_model_us": round(res.est_measured.t_total * 1e6, 6),
        "engine": res.engine, "mode": "measured",
    }
    plan_store.get_store().put(res.key, rec, res.device_kind)
    tuner.clear_planner_caches()    # the next plan_* consults the new entry


def _timed(sl, times) -> tuple:
    return tuple((c.body, c.bm, c.bn, c.bk, c.dim_order, c.kslices, t)
                 for c, t in zip(sl, times))


def _result(family, dims, mdims, key, sl, times, widx, est, dev, **kw):
    return TuneResult(
        family=family, dims=dims, measured_dims=mdims, key=key,
        plan=replace(sl[widx], mode="measured"), t_measured=times[widx],
        t_analytic=times[0], analytic_plan=sl[0], est_measured=est,
        engine="cuda" if dev.type == "cuda" else "plain",
        timed=_timed(sl, times), device_kind=plan_store.device_kind(dev),
        **kw)


# ---------------------------------------------------------------------------
# Family searches
# ---------------------------------------------------------------------------

def time_dense_plans(m: int, k: int, n: int, plans, *, in_bytes: int = 4,
                     out_bytes: int = 4, device=None,
                     repeats: int = DEFAULT_REPEATS,
                     max_elements: int | None = None,
                     epilogue: Epilogue | None = None,
                     b_bytes: int | None = None, panels: int = 1,
                     a_ok: bool = True, b_ok: bool = True,
                     trans: str = "nn", seed: int = 0) -> list[float]:
    """Seconds of each of ``plans`` on one shared problem (scaled into
    ``max_elements``, by default only on the CPU): the timing path of
    ``autotune_gemm``, with no search and no store."""
    dev = resolve_device(device)
    mm, kk, nn = _scale_dense(m, k, n, _budget(dev, max_elements))
    inputs = _dense_inputs(mm, kk, nn, _dtype(in_bytes),
                           _dtype(b_bytes or in_bytes), device=dev,
                           epilogue=epilogue, panels=panels, a_ok=a_ok,
                           b_ok=b_ok, trans=trans, seed=seed)
    return _measure_shortlist(
        list(plans), lambda c: _dense_runner(
            c, mm, nn, _dtype(out_bytes), cuda=dev.type == "cuda",
            epilogue=epilogue, panels=panels, trans=trans), inputs, repeats)


def autotune_gemm(m: int, k: int, n: int, in_bytes: int = 4,
                  out_bytes: int = 4, spec: HopperSpec = H100, *,
                  num_shards: int = 1,
                  top_k: int = DEFAULT_TOP_K,
                  repeats: int = DEFAULT_REPEATS, device=None,
                  max_elements: int | None = None,
                  store: bool = True, epilogue: Epilogue | None = None,
                  b_bytes: int | None = None, panels: int = 1,
                  a_ok: bool = True, b_ok: bool = True, trans: str = "nn",
                  seed: int = 0) -> TuneResult:
    """Measured search for the dense GEMM (``panels`` = 2: the SwiGLU
    pair): CMR shortlist, timed on ``device``, the winner tagged
    ``mode == "measured"`` and stored unless ``store=False``.  The flags
    are the planner's (``plan_gemm``) and key the record; ``trans`` lays
    the operands out as the call does.

    ``epilogue`` widens the search to the fusion decision: each candidate
    also runs unfused (the identity kernel, then one pass per op), every
    candidate is timed with its tail, and the winner's ``fuse`` records
    whether fusing paid on this card.  ``b_bytes`` is B's width when it
    differs from A's (the mixed bf16 x fp32 products)."""
    _no_placement(num_shards)
    dev = resolve_device(device)
    epi_ops = epilogue.num_ops if epilogue is not None else 0
    if panels == 2 and epi_ops:
        raise ValueError("the SwiGLU pair takes no epilogue")
    # Shortlist under the calibrated view, but price est_measured in the
    # raw spec: calibration fractions are relative to it, so refitting
    # against calibrated predictions would collapse to ~1.
    base_spec, spec = spec, tuner.effective_spec(spec)
    flags = dict(panels=panels, b_bytes=b_bytes, a_ok=a_ok, b_ok=b_ok)
    sl = tuner.shortlist(tuner.gemm_candidates(
        m, k, n, in_bytes, out_bytes, spec, epi_ops=epi_ops, **flags), top_k)
    mdims = _scale_dense(m, k, n, _budget(dev, max_elements))
    key = tuner.dense_key(m, k, n, in_bytes, out_bytes, trans=trans, **flags)
    _check_served(dev, store, key, (m, k, n), mdims)
    times = time_dense_plans(m, k, n, sl, in_bytes=in_bytes,
                             out_bytes=out_bytes, device=dev, repeats=repeats,
                             max_elements=max_elements, epilogue=epilogue,
                             b_bytes=b_bytes, panels=panels, a_ok=a_ok,
                             b_ok=b_ok, trans=trans, seed=seed)
    widx = _winner(times)
    est = tuner.dense_estimate(*mdims, in_bytes, out_bytes, base_spec,
                               panels=panels, b_bytes=b_bytes,
                               epi_ops=epi_ops, fuse=sl[widx].fuse,
                               **_plan_fields(sl[widx]))
    res = _result("dense", (m, k, n), mdims, key, sl, times, widx, est, dev,
                  in_bytes=in_bytes, b_bytes=b_bytes)
    if store:
        _store_result(res)
    return res


def _batched_inputs(g, m, k, n, in_dt, b_dt, *, device, shared, panels,
                    a_major, b_ok, trans, seed):
    def make(gen):
        if panels == 2:
            x = (_stored((m, k), in_dt, gen) if shared == "a"
                 else _stored((g, m, k), in_dt, gen))
            return (x, _stored((g, k, n), b_dt, gen, b_ok),
                    _stored((g, k, n), b_dt, gen, b_ok))
        # op(A) (m, k) K-major is stored (m, k), MN-major (k, m); a layout
        # TMA cannot read pads the row stride.  "tn" passes op(A)^T.
        ra, ca = (k, m) if a_major == "mn" else (m, k)
        a = (_stored((ra, ca), in_dt, gen, a_major is not None)
             if shared == "a" else
             _stored((g, ra, ca), in_dt, gen, a_major is not None))
        if (a_major == "mn") != (trans == "tn"):
            a = a.transpose(-1, -2)
        rb, cb = (n, k) if trans == "nt" else (k, n)
        b = (_stored((rb, cb), b_dt, gen, b_ok) if shared == "b"
             else _stored((g, rb, cb), b_dt, gen, b_ok))
        return a, b

    nbytes = g * (m * k * _size(in_dt) + panels * k * n * _size(b_dt)
                  + m * n * 4)
    return _copies(make, nbytes, device, seed)


def _batched_runner(c: GemmPlan, m, n, out_dt, *, cuda, panels, trans):
    if panels == 2:
        return _sig(cuda, c, m, n), (lambda x, wg, wu:
                                     _ops.batched_gemm_swiglu(
                                         x, wg, wu, bm=c.bm, bn=c.bn,
                                         bk=c.bk, out_dtype=out_dt,
                                         body=c.body, kslices=c.kslices))
    return _sig(cuda, c, m, n), (lambda a, b: _ops.batched_gemm(
        a, b, bm=c.bm, bn=c.bn, bk=c.bk, dim_order=c.dim_order, trans=trans,
        out_dtype=out_dt, body=c.body, kslices=c.kslices))


def time_batched_plans(g: int, m: int, k: int, n: int, plans, *,
                       in_bytes: int = 4, out_bytes: int = 4,
                       shared: str = "none", device=None,
                       repeats: int = DEFAULT_REPEATS,
                       max_elements: int | None = None,
                       b_bytes: int | None = None, panels: int = 1,
                       a_major: str | None = "k", b_ok: bool = True,
                       trans: str = "nn", seed: int = 0) -> list[float]:
    """``time_dense_plans`` for the grouped GEMM."""
    dev = resolve_device(device)
    gg, mm, kk, nn = _scale_batched(g, m, k, n, _budget(dev, max_elements))
    inputs = _batched_inputs(gg, mm, kk, nn, _dtype(in_bytes),
                             _dtype(b_bytes or in_bytes), device=dev,
                             shared=shared, panels=panels, a_major=a_major,
                             b_ok=b_ok, trans=trans, seed=seed)
    return _measure_shortlist(
        list(plans), lambda c: _batched_runner(
            c, mm, nn, _dtype(out_bytes), cuda=dev.type == "cuda",
            panels=panels, trans=trans), inputs, repeats)


def autotune_batched_gemm(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                          out_bytes: int = 4, shared: str = "none",
                          spec: HopperSpec = H100, *, num_shards: int = 1,
                          top_k: int = DEFAULT_TOP_K,
                          repeats: int = DEFAULT_REPEATS, device=None,
                          max_elements: int | None = None,
                          store: bool = True, b_bytes: int | None = None,
                          panels: int = 1, a_major: str | None = "k",
                          b_ok: bool = True, trans: str = "nn",
                          seed: int = 0) -> TuneResult:
    """Measured search for the grouped GEMM (``panels`` = 2: the grouped
    SwiGLU pair); the contract of ``autotune_gemm``, ``shared`` marking the
    2-D operand every group uses and the flags those of
    ``plan_batched_gemm``."""
    _no_placement(num_shards)
    dev = resolve_device(device)
    base_spec, spec = spec, tuner.effective_spec(spec)
    flags = dict(panels=panels, b_bytes=b_bytes, a_major=a_major, b_ok=b_ok)
    sl = tuner.shortlist(tuner.batched_candidates(
        g, m, k, n, in_bytes, out_bytes, shared, spec, **flags), top_k)
    mdims = _scale_batched(g, m, k, n, _budget(dev, max_elements))
    key = tuner.batched_key(g, m, k, n, in_bytes, out_bytes, shared,
                            trans=trans, **flags)
    _check_served(dev, store, key, (g, m, k, n), mdims)
    times = time_batched_plans(g, m, k, n, sl, in_bytes=in_bytes,
                               out_bytes=out_bytes, shared=shared, device=dev,
                               repeats=repeats, max_elements=max_elements,
                               trans=trans, seed=seed, **flags)
    widx = _winner(times)
    est = tuner.batched_estimate(*mdims, in_bytes, out_bytes, shared,
                                 base_spec, panels=panels,
                                 **_plan_fields(sl[widx]))
    res = _result("batched", (g, m, k, n), mdims, key, sl, times, widx, est,
                  dev, in_bytes=in_bytes, b_bytes=b_bytes)
    if store:
        _store_result(res)
    return res


def _ragged_inputs(g, total, k, n, in_dt, b_dt, *, device, ragged, panels,
                   a_ok, b_ok, trans, seed):
    offsets = _balanced_offsets(g, total, device)

    def make(gen):
        if ragged == "k":       # dW: x (T, D), dy (T, F), both MN-major
            return (_stored((total, k), in_dt, gen, a_ok),
                    _stored((total, n), b_dt, gen, b_ok), offsets)
        x = _stored((total, k), in_dt, gen, a_ok)
        if panels == 2:
            return (x, _stored((g, k, n), b_dt, gen, b_ok),
                    _stored((g, k, n), b_dt, gen, b_ok), offsets)
        w = (_stored((g, n, k), b_dt, gen, b_ok) if trans == "nt"
             else _stored((g, k, n), b_dt, gen, b_ok))
        return x, w, offsets

    nbytes = (total * k * _size(in_dt) + total * n * 4
              + (total * n * _size(b_dt) if ragged == "k"
                 else panels * g * k * n * _size(b_dt)))
    return _copies(make, nbytes, device, seed)


def _ragged_runner(c: GemmPlan, rows, n, out_dt, *, cuda, ragged, panels,
                   trans):
    if ragged == "k":
        return _sig(cuda, c, rows, n), (lambda x, dy, offs:
                                        _ops.ragged_gemm_dw(
                                            x, dy, offs, bm=c.bm, bn=c.bn,
                                            bk=c.bk, out_dtype=out_dt,
                                            body=c.body))
    if panels == 2:
        return _sig(cuda, c, rows, n), (lambda x, wg, wu, offs:
                                        _ops.ragged_gemm_swiglu(
                                            x, wg, wu, offs, bm=c.bm,
                                            bn=c.bn, bk=c.bk,
                                            out_dtype=out_dt, body=c.body,
                                            kslices=c.kslices))
    return _sig(cuda, c, rows, n), (lambda x, w, offs: _ops.ragged_gemm(
        x, w, offs, bm=c.bm, bn=c.bn, bk=c.bk, trans=trans, out_dtype=out_dt,
        body=c.body, kslices=c.kslices))


def time_ragged_plans(g: int, total: int, k: int, n: int, plans, *,
                      in_bytes: int = 4, out_bytes: int = 4,
                      ragged: str = "m", device=None,
                      repeats: int = DEFAULT_REPEATS,
                      max_elements: int | None = None,
                      b_bytes: int | None = None, panels: int = 1,
                      a_ok: bool = True, b_ok: bool = True,
                      trans: str = "nn", seed: int = 0) -> list[float]:
    """``time_dense_plans`` for the ragged grouped GEMM (``ragged`` "m":
    the forward; "k": the dW)."""
    dev = resolve_device(device)
    gg, tt, kk, nn = _scale_ragged(g, total, k, n,
                                   _budget(dev, max_elements))
    inputs = _ragged_inputs(gg, tt, kk, nn, _dtype(in_bytes),
                            _dtype(b_bytes or in_bytes), device=dev,
                            ragged=ragged, panels=panels, a_ok=a_ok,
                            b_ok=b_ok, trans=trans, seed=seed)
    rows = kk if ragged == "k" else tt
    return _measure_shortlist(
        list(plans), lambda c: _ragged_runner(
            c, rows, nn, _dtype(out_bytes), cuda=dev.type == "cuda",
            ragged=ragged, panels=panels, trans=trans), inputs, repeats)


def autotune_ragged_gemm(g: int, total: int, k: int, n: int,
                         in_bytes: int = 4, out_bytes: int = 4,
                         ragged: str = "m", spec: HopperSpec = H100, *,
                         num_shards: int = 1,
                         top_k: int = DEFAULT_TOP_K,
                         repeats: int = DEFAULT_REPEATS, device=None,
                         max_elements: int | None = None,
                         store: bool = True, b_bytes: int | None = None,
                         panels: int = 1, a_ok: bool = True,
                         b_ok: bool = True, trans: str = "nn",
                         seed: int = 0) -> TuneResult:
    """Measured search for the ragged grouped GEMM, ``ragged`` "m" (the
    forward; ``panels`` = 2: the ragged SwiGLU pair) or "k" (the dW).  The
    harness times a balanced distribution of the signature: the per-group
    counts live on the device at run time, and the plan is keyed by the
    aggregate anyway."""
    _no_placement(num_shards)
    dev = resolve_device(device)
    base_spec, spec = spec, tuner.effective_spec(spec)
    flags = dict(panels=panels, b_bytes=b_bytes, a_ok=a_ok, b_ok=b_ok)
    sl = tuner.shortlist(tuner.ragged_candidates(
        g, total, k, n, in_bytes, out_bytes, ragged, spec, **flags), top_k)
    mdims = _scale_ragged(g, total, k, n, _budget(dev, max_elements))
    key = tuner.ragged_key(g, total, k, n, in_bytes, out_bytes, ragged,
                           trans=trans, **flags)
    _check_served(dev, store, key, (g, total, k, n), mdims)
    times = time_ragged_plans(g, total, k, n, sl, in_bytes=in_bytes,
                              out_bytes=out_bytes, ragged=ragged, device=dev,
                              repeats=repeats, max_elements=max_elements,
                              trans=trans, seed=seed, **flags)
    widx = _winner(times)
    est = tuner.ragged_estimate(*mdims, in_bytes, out_bytes, ragged,
                                base_spec, panels=panels,
                                **_plan_fields(sl[widx]))
    res = _result("ragged", (g, total, k, n), mdims, key, sl, times, widx,
                  est, dev, in_bytes=in_bytes, b_bytes=b_bytes)
    if store:
        _store_result(res)
    return res


# ---------------------------------------------------------------------------
# Calibration: fit the effective HopperSpec constants from (prediction,
# measurement) pairs so unmeasured shapes plan better too.
# ---------------------------------------------------------------------------

def prediction_error(samples, flops_frac: float = 1.0,
                     bw_frac: float = 1.0) -> float:
    """Geomean multiplicative error of the roofline prediction
    ``max(t_compute / flops_frac, t_memory / bw_frac)`` against
    measurement: 1.0 is a perfect model, symmetric in over- and
    under-prediction."""
    logs = []
    for est, t_meas in samples:
        tp = max(est.t_compute / flops_frac, est.t_memory / bw_frac)
        logs.append(abs(math.log(max(tp, 1e-12) / max(t_meas, 1e-12))))
    return math.exp(sum(logs) / len(logs)) if logs else 1.0


def geomean_ratio(samples, flops_frac: float = 1.0,
                  bw_frac: float = 1.0) -> float:
    """Signed geomean of predicted / measured (the bias's direction)."""
    logs = []
    for est, t_meas in samples:
        tp = max(est.t_compute / flops_frac, est.t_memory / bw_frac)
        logs.append(math.log(max(tp, 1e-12) / max(t_meas, 1e-12)))
    return math.exp(sum(logs) / len(logs)) if logs else 1.0


def fit_calibration(samples, *, engine: str = "",
                    spec: HopperSpec = H100) -> Calibration:
    """Grid-fit (achievable-flops fraction, effective-bandwidth fraction)
    minimizing the geomean prediction error over ``samples``, a list of
    (estimate of the measured problem, measured seconds) pairs such as
    ``[(r.est_measured, r.t_measured) for r in results]``: a coarse grid in
    log space (the roofline's max() makes the objective piecewise smooth,
    not convex), then one refinement round around its winner."""
    if not samples:
        return Calibration(engine=engine, base_spec=spec.name)

    def sweep(centers, span, steps):
        best = None
        for ef in range(-steps, steps + 1):
            ff = centers[0] * (10 ** (ef * span / steps))
            for eb in range(-steps, steps + 1):
                bf = centers[1] * (10 ** (eb * span / steps))
                err = prediction_error(samples, ff, bf)
                if best is None or err < best[0]:
                    best = (err, ff, bf)
        return best

    _, ff, bf = sweep((1.0, 1.0), span=4.0, steps=16)       # 1e-4 .. 1e4
    _, ff, bf = sweep((ff, bf), span=0.25, steps=8)         # refine
    return Calibration(flops_frac=ff, bw_frac=bf, n_samples=len(samples),
                       engine=engine, base_spec=spec.name)


def calibrate(results, *, spec: HopperSpec = H100,
              store: bool = True) -> Calibration:
    """Fit the calibration from a batch of ``TuneResult`` and (by default)
    install it in the plan store, where ``tuner.effective_spec`` applies it
    to every later default-spec plan.  ``est_measured`` is always in the
    raw spec, so a refit with a calibration installed composes instead of
    collapsing to ~1.

    1-byte results (``in_bytes == 1``: int8 x int8, priced at the FMA
    body's integer rate, ``HopperSpec.peak_ops_int32``) are fitted apart
    into ``flops_frac_int8``, against the wide results' bandwidth fraction
    (the memory does not change with the arithmetic), or jointly with
    their own bandwidth fraction when there are no wide results.  Mixed
    weight-only results (``b_bytes`` 1, wide activations) compute in fp32
    and stay in the main fit.  The harness makes its 1-byte operands int8,
    so the fraction covers int8 x int8 only: fp8 x fp8 prices at the fp32
    rate (``HopperSpec.kernel_flops``) and takes the main fraction."""
    engines = {r.engine for r in results}
    wide = [r for r in results if r.in_bytes != 1]
    narrow = [(r.est_measured, r.t_measured) for r in results
              if r.in_bytes == 1]
    cal = fit_calibration([(r.est_measured, r.t_measured) for r in wide],
                          engine=",".join(sorted(engines)), spec=spec)
    if narrow:
        if wide:
            fracs = (10.0 ** (e * 4.0 / 64) for e in range(-64, 65))
            int8_frac = min(fracs, key=lambda ff: prediction_error(
                narrow, ff, cal.bw_frac))
        else:
            ncal = fit_calibration(narrow, engine=cal.engine, spec=spec)
            cal = replace(cal, bw_frac=ncal.bw_frac)
            int8_frac = ncal.flops_frac
        cal = replace(cal, flops_frac_int8=int8_frac,
                      n_samples=len(results))
    if store:
        st = plan_store.get_store()
        if st.calibration is not None:   # keep a fitted ICI fraction
            cal = replace(cal, ici_frac=st.calibration.ici_frac)
        kinds = {r.device_kind for r in results}
        st.kind = st.kind or (kinds.pop() if len(kinds) == 1
                              else plan_store.device_kind())
        st.calibration = cal
        tuner.clear_planner_caches()
    return cal


def calibrate_ici(*args, **kwargs):
    """Not ported: the interconnect fraction is fitted by the measured
    placed search."""
    raise NotImplementedError("calibrate_ici comes with the measured placed "
                              "search, slice 15 of ROADMAP Queue 1 item 10")


def time_placed_ragged_e2e(*args, **kwargs):
    """Not ported: part of the measured placed search."""
    raise NotImplementedError("placed end-to-end timing comes with the "
                              "measured placed search, slice 15 of ROADMAP "
                              "Queue 1 item 10")


def time_placed_dense_e2e(*args, **kwargs):
    """Not ported: part of the measured placed search."""
    raise NotImplementedError("placed end-to-end timing comes with the "
                              "measured placed search, slice 15 of ROADMAP "
                              "Queue 1 item 10")


# ---------------------------------------------------------------------------
# Persistence: thin veneers over plan_store that also invalidate the
# planner caches, so a load takes effect at once.
# ---------------------------------------------------------------------------

def load_plan_cache(path: str) -> int:
    """Adopt a plan-store file (0 entries for a missing, corrupt or
    other-device file; never raises) and invalidate the planner caches so
    the next ``plan_*`` serves ``mode == "cached"`` plans."""
    n = plan_store.get_store().load(path)
    tuner.clear_planner_caches()
    return n


def save_plan_cache(path: str | None = None) -> str:
    return plan_store.get_store().save(path)


def clear_plan_store() -> None:
    """Forget all in-memory measured plans and the calibration (the file is
    untouched) and invalidate the planner caches."""
    plan_store.reset_store()
    tuner.clear_planner_caches()
