"""Dynamic adjusting (paper Sec. IV-C): choose the body and tile of each
GEMM shape from the CMR model, once per shape signature.

The candidates are exactly what the CUDA kernels are compiled for: the FMA
body's tiles (``kernels.ftimm.kernel.TILES``) in both grid orders, and,
where the call's operand types and layouts allow them
(``kernel.gemm_bodies`` / ``grouped_bodies`` / ``ragged_bodies`` /
``ragged_dw_bodies``), the tensor-core tiles (``kernel.TC_TILES``;
``GROUP_TC_TILE`` for the grouped and ragged kernels) and the weight
streams' K slice counts; each is filtered by the 227 KB shared-memory
budget of a block and scored with ``cmr.estimate*`` at its body's own
rate.
Plans are LRU-cached per signature, so planning happens once per shape and
is free afterwards.  Every plan is analytic (the CMR argmin): the measured
plan store, autotuning, calibration and placement on a mesh are not ported
yet.  ``plan_moe_dispatch`` sizes an MoE layer's expert GEMM rows and holds
the capacity rounding rule that decides which tokens drop.
"""
from __future__ import annotations

import collections
import functools
from dataclasses import dataclass

from ...kernels.ftimm.kernel import (GROUP_TC_TILE, GSTREAM_ROWS,
                                     STREAM_SMEM, STREAM_STRIP, TC_STAGES,
                                     TC_TILES, TILES, gemm_bodies,
                                     grouped_bodies, ragged_bodies,
                                     ragged_dw_bodies, stream_rows,
                                     stream_slice)
from .cmr import (H100, HopperSpec, PlanEstimate, ceil_to, estimate,
                  estimate_batched, estimate_group_stream, estimate_ragged,
                  estimate_stream)
from .shapes import GemmClass, classify


@dataclass(frozen=True)
class GemmPlan:
    bm: int
    bn: int
    bk: int
    nsplit: int = 1                 # the split-K kernel's factor (always 1
                                    # on the model paths, as in the reference)
    dim_order: str = "mn"
    gemm_class: GemmClass = GemmClass.REGULAR
    est: PlanEstimate | None = None
    mode: str = "analytic"
    body: str = "fma"               # "fma" | "tc" | "stream"
    kslices: int = 1                # a stream body's K slices

    @property
    def t_total(self) -> float:
        return self.est.t_total if self.est is not None else 0.0

    def kernel_kwargs(self) -> dict:
        return dict(bm=self.bm, bn=self.bn, bk=self.bk, nsplit=self.nsplit,
                    dim_order=self.dim_order, body=self.body,
                    kslices=self.kslices)


def _candidates(cls: GemmClass, estimator, spec: HopperSpec,
                orders: tuple[str, ...] = ("mn", "nm"), tiles=TILES,
                body: str = "fma",
                order_aware: bool = False) -> list[GemmPlan]:
    cands = []
    for bm, bn, bk in tiles:
        for order in orders:
            # An ``order_aware`` estimator (the dense tensor-core body)
            # prices the grid order's L2 reuse; the others do not see L2
            # locality, so the two orders tie and the argmin keeps "mn"
            # (both stay candidates).
            e = (estimator(bm=bm, bn=bn, bk=bk, dim_order=order)
                 if order_aware else estimator(bm=bm, bn=bn, bk=bk))
            if e.smem_bytes > spec.smem_per_block:
                continue
            cands.append(GemmPlan(bm=bm, bn=bn, bk=bk, dim_order=order,
                                  gemm_class=cls, est=e, body=body))
    return cands


def _stream_candidates(cls: GemmClass, m: int, k: int, n: int, in_bytes: int,
                       out_bytes: int, spec: HopperSpec) -> list[GemmPlan]:
    """The stream body at each K slice count 1, 2, 4, ... 64 (as cut by
    ``stream_slice``) whose slice of staged rows fits STREAM_SMEM."""
    rows = stream_rows(m)
    cands, seen = [], set()
    for want in (1, 2, 4, 8, 16, 32, 64):
        sl, slices = stream_slice(k, want)
        if slices in seen or rows * sl * 2 > STREAM_SMEM:
            continue
        seen.add(slices)
        e = estimate_stream(m, k, n, kslices=slices, in_bytes=in_bytes,
                            out_bytes=out_bytes, spec=spec)
        cands.append(GemmPlan(bm=rows, bn=STREAM_STRIP, bk=sl,
                              gemm_class=cls, est=e, body="stream",
                              kslices=slices))
    return cands


def _group_stream_candidates(cls: GemmClass, groups: int, rows: int, k: int,
                             n: int, in_bytes: int, out_bytes: int,
                             spec: HopperSpec,
                             panels: int = 1) -> list[GemmPlan]:
    """The grouped / ragged stream at each K slice count 1, 2, 4, ... 64 (as
    cut by ``stream_slice``), ``groups`` panels reached (``panels`` = 2:
    the SwiGLU pair's two each), ``rows`` rows in all.  Its slices stage no
    rows, so every count fits shared memory."""
    cands, seen = [], set()
    for want in (1, 2, 4, 8, 16, 32, 64):
        sl, slices = stream_slice(k, want)
        if slices in seen:
            continue
        seen.add(slices)
        e = estimate_group_stream(groups, rows, k, n, kslices=slices,
                                  in_bytes=in_bytes, out_bytes=out_bytes,
                                  panels=panels, spec=spec)
        cands.append(GemmPlan(bm=GSTREAM_ROWS, bn=STREAM_STRIP, bk=sl,
                              gemm_class=cls, est=e, body="stream",
                              kslices=slices))
    return cands


def gemm_candidates(m: int, k: int, n: int, in_bytes: int = 4,
                    out_bytes: int = 4, spec: HopperSpec = H100, *,
                    panels: int = 1, b_bytes: int | None = None,
                    a_ok: bool = True, b_ok: bool = True) -> list[GemmPlan]:
    """Every compiled tile (x grid order) of every body the call allows
    (``gemm_bodies``: the operand widths ``in_bytes`` for A and ``b_bytes``
    for B, and whether TMA can read A and B as laid out) that fits a
    block's shared memory, scored by the CMR model.  ``panels`` = 2 plans
    the dense SwiGLU pair (``ftimm_gemm_swiglu``; ``a_ok``: TMA reads x
    K-major, ``b_ok``: both panels): its stream is the group stream with
    one group (``estimate_group_stream``), its tensor cores the pair tile
    GROUP_TC_TILE with both panels priced."""
    b_bytes = b_bytes or in_bytes
    cls = classify(m, k, n)
    width = max(in_bytes, b_bytes)
    cands = []
    for body in gemm_bodies(in_bytes, b_bytes, m, a_ok, b_ok, panels):
        if body == "stream":
            cands += (_group_stream_candidates(cls, 1, m, k, n, width,
                                               out_bytes, spec, panels=2)
                      if panels == 2 else
                      _stream_candidates(cls, m, k, n, width, out_bytes,
                                         spec))
            continue
        est = functools.partial(estimate, m, k, n, in_bytes=width,
                                out_bytes=out_bytes, panels=panels, spec=spec,
                                body=body, stages=TC_STAGES["ftimm_gemm"])
        tc_tiles = (GROUP_TC_TILE,) if panels == 2 else TC_TILES
        cands += _candidates(cls, est, spec,
                             tiles=tc_tiles if body == "tc" else TILES,
                             body=body, order_aware=body == "tc")
    return cands


def batched_candidates(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                       out_bytes: int = 4, shared: str = "none",
                       spec: HopperSpec = H100, *, panels: int = 1,
                       b_bytes: int | None = None, a_major: str | None = "k",
                       b_ok: bool = True) -> list[GemmPlan]:
    """Candidates for the grouped GEMM: every body ``grouped_bodies``
    allows (``in_bytes`` / ``b_bytes``: A's and B's widths; ``a_major``:
    how TMA reads op(A), "k", "mn" or None; ``b_ok``: whether it reads
    op(B)) -- the FMA tiles in both grid orders, the tensor-core tile in
    both, the weight stream's slice counts (every group's M rows, all G
    panels read).  ``panels`` = 2 for the grouped SwiGLU pair, which takes
    the same bodies with two B panels (``b_ok``: TMA reads both)."""
    cls = classify(m, k, n)
    cands = []
    for body in grouped_bodies(in_bytes, b_bytes or in_bytes, m, a_major,
                               b_ok):
        if body == "stream":
            cands += _group_stream_candidates(cls, g, g * m, k, n, in_bytes,
                                              out_bytes, spec, panels)
            continue
        est = functools.partial(estimate_batched, g, m, k, n,
                                shared_a=shared == "a",
                                shared_b=shared == "b", in_bytes=in_bytes,
                                out_bytes=out_bytes, panels=panels,
                                spec=spec, body=body,
                                stages=TC_STAGES["ftimm_gemm_grouped"])
        cands += _candidates(cls, est, spec,
                             tiles=(GROUP_TC_TILE,) if body == "tc" else TILES,
                             body=body, order_aware=body == "tc")
    return cands


def ragged_candidates(g: int, total: int, k: int, n: int, in_bytes: int = 4,
                      out_bytes: int = 4, ragged: str = "m",
                      spec: HopperSpec = H100, *, panels: int = 1,
                      b_bytes: int | None = None, a_ok: bool = True,
                      b_ok: bool = True) -> list[GemmPlan]:
    """Candidates for the ragged grouped GEMM, scored by
    ``estimate_ragged`` (the stream: ``estimate_group_stream``).  The
    per-group *mean* shape is classified: (rows, k, n) for the forward,
    (k, rows, n) for the dW (``ragged="k"``, whose contraction is the
    rows).  The forward offers every body ``ragged_bodies`` allows
    (``a_ok``: TMA reads x K-major; ``b_ok``: it reads the panels; the
    stream prices the min(g, total) panels ``total`` rows can reach); the
    dW the tensor-core tiles where ``ragged_dw_bodies`` allows them
    (``a_ok`` / ``b_ok``: TMA reads x^T and dy MN-major).  No grid-order
    choice: the ragged kernels fix their walk."""
    mean = max(total // max(g, 1), 1)
    cls = classify(mean, k, n) if ragged == "m" else classify(k, mean, n)
    b_bytes = b_bytes or in_bytes
    if ragged == "k":
        bodies, kernel, tc_tiles = (ragged_dw_bodies(in_bytes, b_bytes, a_ok,
                                                     b_ok),
                                    "ftimm_gemm_ragged_dw", TC_TILES)
    else:
        bodies, kernel, tc_tiles = (ragged_bodies(in_bytes, b_bytes, total,
                                                  a_ok, b_ok),
                                    "ftimm_gemm_ragged", (GROUP_TC_TILE,))
    cands = []
    for body in bodies:
        if body == "stream":
            cands += _group_stream_candidates(cls, min(g, total), total, k, n,
                                              in_bytes, out_bytes, spec,
                                              panels)
            continue
        est = functools.partial(estimate_ragged, g, total, k, n,
                                ragged=ragged, in_bytes=in_bytes,
                                out_bytes=out_bytes, panels=panels, spec=spec,
                                body=body, stages=TC_STAGES[kernel])
        cands += _candidates(cls, est, spec, orders=("mn",),
                             tiles=tc_tiles if body == "tc" else TILES,
                             body=body)
    return cands


def _better(a: GemmPlan, b: GemmPlan) -> bool:
    ta, tb = a.est.t_total, b.est.t_total
    if abs(ta - tb) > 0.02 * max(ta, tb):
        return ta < tb
    # Tie-break as the paper does: prefer the longer K step (more
    # accumulator reuse per sync), then less padded compute.
    if a.bk != b.bk:
        return a.bk > b.bk
    return a.est.flops_padded < b.est.flops_padded


def argmin_plan(cands: list[GemmPlan]) -> GemmPlan:
    """The analytic winner under the CMR model (paper tie-break rules)."""
    best = cands[0]
    for cand in cands[1:]:
        if _better(cand, best):
            best = cand
    return best


@functools.lru_cache(maxsize=8192)
def plan_gemm(m: int, k: int, n: int, in_bytes: int = 4, out_bytes: int = 4,
              spec: HopperSpec = H100, *, panels: int = 1,
              b_bytes: int | None = None, a_ok: bool = True,
              b_ok: bool = True) -> GemmPlan:
    """Pick the body and tile for C(M,N) = A(M,K) B(K,N).  ``in_bytes`` /
    ``b_bytes``: A's and B's element widths (B defaults to A's); ``a_ok`` /
    ``b_ok``: whether TMA can read each operand as laid out
    (``kernel.gemm_operands_ok``).  The epilogue is always fused into the
    flush, so it does not change the choice."""
    return argmin_plan(gemm_candidates(m, k, n, in_bytes, out_bytes, spec,
                                       panels=panels, b_bytes=b_bytes,
                                       a_ok=a_ok, b_ok=b_ok))


@functools.lru_cache(maxsize=8192)
def plan_batched_gemm(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                      out_bytes: int = 4, shared: str = "none",
                      spec: HopperSpec = H100, *, panels: int = 1,
                      b_bytes: int | None = None, a_major: str | None = "k",
                      b_ok: bool = True) -> GemmPlan:
    """Pick the body and tile for the grouped GEMM C(g) = A(g) B(g);
    ``shared`` marks a 2-D operand used by every group ("a" | "b" |
    "none"); ``panels`` = 2 plans the grouped SwiGLU pair; ``b_bytes``,
    ``a_major`` and ``b_ok`` as for ``batched_candidates``
    (``kernel.grouped_operands`` gives the last two)."""
    return argmin_plan(batched_candidates(g, m, k, n, in_bytes, out_bytes,
                                          shared, spec, panels=panels,
                                          b_bytes=b_bytes, a_major=a_major,
                                          b_ok=b_ok))


@functools.lru_cache(maxsize=8192)
def plan_ragged_gemm(g: int, total: int, k: int, n: int, in_bytes: int = 4,
                     out_bytes: int = 4, ragged: str = "m",
                     spec: HopperSpec = H100, *, panels: int = 1,
                     b_bytes: int | None = None, a_ok: bool = True,
                     b_ok: bool = True) -> GemmPlan:
    """Pick the tile for a ragged grouped GEMM over ``g`` groups.  The key
    (g, total, k, n, widths) is the distribution signature: the per-group
    counts stay on the device, so the plan prices the aggregate (total
    rows plus one partial chunk per group) and serves every call with the
    same signature.  ``ragged="m"``: the forward, rows are ragged; ``a_ok``
    / ``b_ok`` say whether TMA reads x K-major and the panels
    (``kernel.ragged_operands``), ``b_bytes`` is the panels' width.
    ``ragged="k"``: the dW, the ragged rows are the contraction and ``k`` x
    ``n`` is each group's output panel (D x F); ``a_ok`` / ``b_ok`` say
    whether TMA reads x^T and dy MN-major (``kernel.ragged_dw_operands_mn``),
    ``b_bytes`` is dy's width (defaults to x's)."""
    return argmin_plan(ragged_candidates(g, total, k, n, in_bytes, out_bytes,
                                         ragged, spec, panels=panels,
                                         b_bytes=b_bytes, a_ok=a_ok,
                                         b_ok=b_ok))


def capacity_multiple(elt_bytes: int) -> int:
    """The capacity rounding of the reference: a multiple of its TPU
    register tile's sublane count for the compute type (8 rows fp32, 16
    bf16, 32 one-byte types), and at least one such multiple.  On the GPU
    this is semantics, not layout: the capacity decides which tokens drop,
    so the port keeps the reference's rule."""
    return 8 if elt_bytes >= 4 else (32 if elt_bytes == 1 else 16)


@dataclass(frozen=True)
class MoeDispatchPlan:
    """``rows``: the expert-GEMM row count one MoE layer's dispatch mode
    produces -- E x capacity for "capacity" (every expert padded to the
    capacity, overflow dropped), T x top_k for "ragged" (every routed
    copy)."""
    rows: int


@functools.lru_cache(maxsize=8192)
def plan_moe_dispatch(t: int, e: int, top_k: int, d_model: int, d_ff: int,
                      *, dispatch: str = "capacity",
                      capacity_factor: float = 1.25,
                      elt_bytes: int = 2) -> MoeDispatchPlan:
    """Rows of one MoE layer's expert GEMMs under ``dispatch``.  The
    capacity is int(T * top_k * factor / E) rounded up to
    ``capacity_multiple(elt_bytes)``.  ``d_model`` / ``d_ff`` stay in the
    signature as in the reference (they size the layer's GEMMs for callers
    that price the rows).  Expert placement on a mesh is not ported."""
    if dispatch == "ragged":
        return MoeDispatchPlan(rows=t * top_k)
    if dispatch != "capacity":
        raise ValueError(f"unknown moe dispatch: {dispatch}")
    s = capacity_multiple(elt_bytes)
    c = int(t * top_k * capacity_factor / e)
    return MoeDispatchPlan(rows=e * max(s, ceil_to(c, s)))


PLAN_MODE_COUNTS: collections.Counter = collections.Counter()
EPILOGUE_COUNTS: collections.Counter = collections.Counter()


def note_plan_use(family: str, plan: GemmPlan) -> None:
    """Dispatch calls this each time a plan reaches an engine, keyed
    (family, mode)."""
    PLAN_MODE_COUNTS[(family, plan.mode)] += 1


def note_epilogue(family: str, fused: bool) -> None:
    """Dispatch calls this for each GEMM that carries an epilogue."""
    EPILOGUE_COUNTS[(family, "fused" if fused else "separate")] += 1


def epilogue_stats() -> dict[str, dict[str, int]]:
    """{family: {"fused"|"separate": count}} census of epilogue servings."""
    out: dict[str, dict[str, int]] = {}
    for (family, kind), count in sorted(EPILOGUE_COUNTS.items()):
        out.setdefault(family, {})[kind] = count
    return out


def plan_mode_stats() -> dict[str, dict[str, int]]:
    """{family: {mode: count}} census of plans that reached an engine, plus
    an ``"epilogue"`` entry with fused-vs-separate totals when any GEMM
    carried an epilogue."""
    out: dict[str, dict[str, int]] = {}
    for (family, mode), count in sorted(PLAN_MODE_COUNTS.items()):
        out.setdefault(family, {})[mode] = count
    epi: dict[str, int] = {}
    for (_family, kind), count in EPILOGUE_COUNTS.items():
        epi[kind] = epi.get(kind, 0) + count
    if epi:
        out["epilogue"] = dict(sorted(epi.items()))
    return out


def clear_plan_cache() -> None:
    """Reset the planner caches and the telemetry counters."""
    plan_gemm.cache_clear()
    plan_batched_gemm.cache_clear()
    plan_ragged_gemm.cache_clear()
    plan_moe_dispatch.cache_clear()
    PLAN_MODE_COUNTS.clear()
    EPILOGUE_COUNTS.clear()
