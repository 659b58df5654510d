"""Dynamic adjusting (paper Sec. IV-C): choose the tile of each GEMM shape
from the CMR model, once per shape signature.

The candidates are exactly the tiles the CUDA kernels are compiled for
(``kernels.ftimm.kernel.TILES``) in both grid orders, filtered by the
227 KB shared-memory budget of a block, and scored with ``cmr.estimate*``.
Plans are LRU-cached per signature, so planning happens once per shape and
is free afterwards.  Every plan is analytic (the CMR argmin): the measured
plan store, autotuning, calibration and placement on a mesh are not ported
yet.
"""
from __future__ import annotations

import collections
import functools
from dataclasses import dataclass

from ...kernels.ftimm.kernel import TILES
from .cmr import H100, HopperSpec, PlanEstimate, estimate, estimate_batched
from .shapes import GemmClass, classify


@dataclass(frozen=True)
class GemmPlan:
    bm: int
    bn: int
    bk: int
    dim_order: str = "mn"
    gemm_class: GemmClass = GemmClass.REGULAR
    est: PlanEstimate | None = None
    mode: str = "analytic"

    @property
    def t_total(self) -> float:
        return self.est.t_total if self.est is not None else 0.0

    def kernel_kwargs(self) -> dict:
        return dict(bm=self.bm, bn=self.bn, bk=self.bk,
                    dim_order=self.dim_order)


def _candidates(cls: GemmClass, estimator,
                spec: HopperSpec) -> list[GemmPlan]:
    cands = []
    for bm, bn, bk in TILES:
        e = estimator(bm=bm, bn=bn, bk=bk)
        if e.smem_bytes > spec.smem_per_block:
            continue
        # The model does not see L2 locality, so the two grid orders tie
        # and the argmin keeps "mn"; both stay candidates for measurement.
        for order in ("mn", "nm"):
            cands.append(GemmPlan(bm=bm, bn=bn, bk=bk, dim_order=order,
                                  gemm_class=cls, est=e))
    return cands


def gemm_candidates(m: int, k: int, n: int, in_bytes: int = 4,
                    out_bytes: int = 4, spec: HopperSpec = H100, *,
                    panels: int = 1) -> list[GemmPlan]:
    """Every compiled tile (x grid order) that fits a block's shared memory,
    scored by the CMR model.  ``panels`` = 2 for the fused SwiGLU pair."""
    est = functools.partial(estimate, m, k, n, in_bytes=in_bytes,
                            out_bytes=out_bytes, panels=panels, spec=spec)
    return _candidates(classify(m, k, n), est, spec)


def batched_candidates(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                       out_bytes: int = 4, shared: str = "none",
                       spec: HopperSpec = H100) -> list[GemmPlan]:
    """Candidate tiles for the grouped GEMM (same menu as the dense one)."""
    est = functools.partial(estimate_batched, g, m, k, n,
                            shared_a=shared == "a", shared_b=shared == "b",
                            in_bytes=in_bytes, out_bytes=out_bytes, spec=spec)
    return _candidates(classify(m, k, n), est, spec)


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
              spec: HopperSpec = H100, *, panels: int = 1) -> GemmPlan:
    """Pick the tile for C(M,N) = A(M,K) B(K,N).  The epilogue is always
    fused into the flush, so it does not change the choice."""
    return argmin_plan(gemm_candidates(m, k, n, in_bytes, out_bytes, spec,
                                       panels=panels))


@functools.lru_cache(maxsize=8192)
def plan_batched_gemm(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                      out_bytes: int = 4, shared: str = "none",
                      spec: HopperSpec = H100) -> GemmPlan:
    """Pick the tile for the grouped GEMM C(g) = A(g) B(g); ``shared`` marks
    a 2-D operand used by every group ("a" | "b" | "none")."""
    return argmin_plan(batched_candidates(g, m, k, n, in_bytes, out_bytes,
                                          shared, spec))


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
    PLAN_MODE_COUNTS.clear()
    EPILOGUE_COUNTS.clear()
