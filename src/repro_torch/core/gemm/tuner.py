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
is free afterwards.  Each planner first consults the measured plan store
(``plan_store``, filled by ``autotune``): a record measured on this card
for the signature's key is matched against the call's candidates and
served as ``mode == "cached"``; otherwise the plan is the CMR argmin
(``"analytic"``), under the store's calibration when it has one
(``effective_spec``).  Placement on a mesh is not ported yet.
``plan_moe_dispatch`` sizes an MoE layer's expert GEMM rows and holds the
capacity rounding rule that decides which tokens drop.
"""
from __future__ import annotations

import collections
import functools
from dataclasses import dataclass, replace

from ...kernels.ftimm.kernel import (GROUP_TC_TILE, GSTREAM_ROWS,
                                     STREAM_SMEM, STREAM_STRIP, TC_STAGES,
                                     TC_TILES, TILES, fma_tiles,
                                     gemm_bodies,
                                     grouped_bodies, ragged_bodies,
                                     ragged_dw_bodies, stream_rows,
                                     stream_slice)
from . import plan_store
from .cmr import (H100, HopperSpec, PlanEstimate, ceil_to, estimate,
                  estimate_batched, estimate_group_stream, estimate_ragged,
                  estimate_stream, with_epilogue)
from .shapes import GemmClass, classify


@dataclass(frozen=True)
class GemmPlan:
    bm: int
    bn: int
    bk: int
    nsplit: int = 1                 # the split-K kernel's factor (> 1 only
                                    # from a stored record, as in the
                                    # reference)
    dim_order: str = "mn"
    gemm_class: GemmClass = GemmClass.REGULAR
    est: PlanEstimate | None = None
    mode: str = "analytic"
    body: str = "fma"               # "fma" | "tc" | "stream"
    kslices: int = 1                # a stream body's K slices
    fuse: bool = True               # the epilogue in the flush, or (False,
                                    # a measured winner) as separate passes

    @property
    def t_total(self) -> float:
        return self.est.t_total if self.est is not None else 0.0

    def kernel_kwargs(self) -> dict:
        return dict(bm=self.bm, bn=self.bn, bk=self.bk, nsplit=self.nsplit,
                    dim_order=self.dim_order, body=self.body,
                    kslices=self.kslices)


# ---------------------------------------------------------------------------
# The price of one plan: what the candidate generators score each candidate
# with, and what the measured tuner prices a plan with at other dims.
# ---------------------------------------------------------------------------

def dense_estimate(m: int, k: int, n: int, in_bytes: int = 4,
                   out_bytes: int = 4, spec: HopperSpec = H100, *,
                   body: str, bm: int, bn: int, bk: int,
                   dim_order: str = "mn", kslices: int = 1, panels: int = 1,
                   b_bytes: int | None = None, epi_ops: int = 0,
                   fuse: bool = True, fp8: bool = False) -> PlanEstimate:
    """The CMR price of one dense plan (``panels`` = 2: the SwiGLU pair,
    whose stream is the group stream with one group), at the wider of the
    two operand widths, with an unfused tail's passes when ``fuse`` is
    False; ``fp8``: 1-byte operands are fp8, not int8."""
    width = max(in_bytes, b_bytes or in_bytes)
    if body == "stream" and panels == 2:
        return estimate_group_stream(1, m, k, n, kslices=kslices,
                                     in_bytes=width, out_bytes=out_bytes,
                                     panels=2, spec=spec)
    if body == "stream":
        e = estimate_stream(m, k, n, kslices=kslices, in_bytes=width,
                            out_bytes=out_bytes, spec=spec)
    else:
        e = estimate(m, k, n, bm=bm, bn=bn, bk=bk, in_bytes=width,
                     out_bytes=out_bytes, panels=panels, spec=spec,
                     body=body, stages=TC_STAGES["ftimm_gemm"],
                     dim_order=dim_order, fp8=fp8)
    return with_epilogue(e, m, n, out_bytes, epi_ops if panels == 1 else 0,
                         fuse, spec)


def batched_estimate(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                     out_bytes: int = 4, shared: str = "none",
                     spec: HopperSpec = H100, *, body: str, bm: int, bn: int,
                     bk: int, dim_order: str = "mn", kslices: int = 1,
                     panels: int = 1) -> PlanEstimate:
    """The CMR price of one grouped plan: the stream reads every group's
    M rows and all G panels."""
    if body == "stream":
        return estimate_group_stream(g, g * m, k, n, kslices=kslices,
                                     in_bytes=in_bytes, out_bytes=out_bytes,
                                     panels=panels, spec=spec)
    return estimate_batched(g, m, k, n, bm=bm, bn=bn, bk=bk,
                            shared_a=shared == "a", shared_b=shared == "b",
                            in_bytes=in_bytes, out_bytes=out_bytes,
                            panels=panels, spec=spec, body=body,
                            stages=TC_STAGES["ftimm_gemm_grouped"],
                            dim_order=dim_order)


def ragged_estimate(g: int, total: int, k: int, n: int, in_bytes: int = 4,
                    out_bytes: int = 4, ragged: str = "m",
                    spec: HopperSpec = H100, *, body: str, bm: int, bn: int,
                    bk: int, dim_order: str = "mn", kslices: int = 1,
                    panels: int = 1, fp8: bool = False) -> PlanEstimate:
    """The CMR price of one ragged plan (the kernels fix their walk, so
    ``dim_order`` prices nothing): the stream reaches min(g, total)
    panels; ``fp8``: 1-byte operands are fp8, not int8."""
    if body == "stream":
        return estimate_group_stream(min(g, total), total, k, n,
                                     kslices=kslices, in_bytes=in_bytes,
                                     out_bytes=out_bytes, panels=panels,
                                     spec=spec)
    kernel = "ftimm_gemm_ragged_dw" if ragged == "k" else "ftimm_gemm_ragged"
    return estimate_ragged(g, total, k, n, bm=bm, bn=bn, bk=bk,
                           ragged=ragged, in_bytes=in_bytes,
                           out_bytes=out_bytes, panels=panels, spec=spec,
                           body=body, stages=TC_STAGES[kernel], fp8=fp8)


def _candidates(cls: GemmClass, price, spec: HopperSpec,
                orders: tuple[str, ...] = ("mn", "nm"), tiles=TILES,
                body: str = "fma") -> list[GemmPlan]:
    """Each tile of ``body`` in each grid order that fits a block's shared
    memory.  Only the dense and grouped tensor-core bodies' price sees the
    order's L2 reuse; for the others the two orders tie and the argmin
    keeps "mn" (both stay candidates)."""
    cands = []
    for bm, bn, bk in tiles:
        for order in orders:
            e = price(body=body, bm=bm, bn=bn, bk=bk, dim_order=order)
            if e.smem_bytes > spec.smem_per_block:
                continue
            cands.append(GemmPlan(bm=bm, bn=bn, bk=bk, dim_order=order,
                                  gemm_class=cls, est=e, body=body))
    return cands


def _stream_candidates(cls: GemmClass, price, k: int, rows: int,
                       staged: bool) -> list[GemmPlan]:
    """The stream body at each K slice count 1, 2, 4, ... 64 (as cut by
    ``stream_slice``).  ``rows``: the CTA's row count (``stream_rows`` for
    ``ftimm_gemm``'s register stream, GSTREAM_ROWS for the group stream);
    ``staged``: the register stream's slice of staged rows must fit
    STREAM_SMEM (the group stream stages no rows)."""
    cands, seen = [], set()
    for want in (1, 2, 4, 8, 16, 32, 64):
        sl, slices = stream_slice(k, want)
        if slices in seen or (staged and rows * sl * 2 > STREAM_SMEM):
            continue
        seen.add(slices)
        e = price(body="stream", bm=rows, bn=STREAM_STRIP, bk=sl,
                  kslices=slices)
        cands.append(GemmPlan(bm=rows, bn=STREAM_STRIP, bk=sl,
                              gemm_class=cls, est=e, body="stream",
                              kslices=slices))
    return cands


def gemm_candidates(m: int, k: int, n: int, in_bytes: int = 4,
                    out_bytes: int = 4, spec: HopperSpec = H100, *,
                    panels: int = 1, b_bytes: int | None = None,
                    a_ok: bool = True, b_ok: bool = True,
                    epi_ops: int = 0, fp8: bool = False) -> list[GemmPlan]:
    """Every compiled tile (x grid order) of every body the call allows
    (``gemm_bodies``: the operand widths ``in_bytes`` for A and ``b_bytes``
    for B, and whether TMA can read A and B as laid out) that fits a
    block's shared memory, scored by the CMR model (``dense_estimate``).
    ``panels`` = 2 plans the dense SwiGLU pair (``ftimm_gemm_swiglu``;
    ``a_ok``: TMA reads x K-major, ``b_ok``: both panels): its stream is
    the group stream with one group, its tensor cores the pair tile
    GROUP_TC_TILE with both panels priced.  ``epi_ops`` > 0 declares an
    elementwise tail of that many ops (``Epilogue.num_ops``): every
    candidate then also comes unfused (``fuse`` False), priced with the
    tail's extra passes (``cmr.with_epilogue``).  ``fp8``: 1-byte operands
    are fp8, not int8 (they price at the fp32 FMA rate)."""
    b_bytes = b_bytes or in_bytes
    cls = classify(m, k, n)
    price = functools.partial(dense_estimate, m, k, n, in_bytes, out_bytes,
                              spec, panels=panels, b_bytes=b_bytes, fp8=fp8)
    cands = []
    for body in gemm_bodies(in_bytes, b_bytes, m, a_ok, b_ok, panels):
        if body == "stream":
            cands += (_stream_candidates(cls, price, k, GSTREAM_ROWS, False)
                      if panels == 2 else
                      _stream_candidates(cls, price, k, stream_rows(m), True))
            continue
        tc_tiles = (GROUP_TC_TILE,) if panels == 2 else TC_TILES
        cands += _candidates(cls, price, spec,
                             tiles=(tc_tiles if body == "tc"
                                    else fma_tiles(in_bytes, b_bytes)),
                             body=body)
    if epi_ops > 0 and panels == 1:
        cands = [replace(c, fuse=fuse, est=with_epilogue(
            c.est, m, n, out_bytes, epi_ops, fuse, spec))
            for c in cands for fuse in (True, False)]
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
    panels read), scored by ``batched_estimate``.  ``panels`` = 2 for the
    grouped SwiGLU pair, which takes the same bodies with two B panels
    (``b_ok``: TMA reads both)."""
    cls = classify(m, k, n)
    price = functools.partial(batched_estimate, g, m, k, n, in_bytes,
                              out_bytes, shared, spec, panels=panels)
    cands = []
    for body in grouped_bodies(in_bytes, b_bytes or in_bytes, m, a_major,
                               b_ok):
        if body == "stream":
            cands += _stream_candidates(cls, price, k, GSTREAM_ROWS, False)
            continue
        cands += _candidates(cls, price, spec,
                             tiles=(GROUP_TC_TILE,) if body == "tc" else TILES,
                             body=body)
    return cands


def ragged_candidates(g: int, total: int, k: int, n: int, in_bytes: int = 4,
                      out_bytes: int = 4, ragged: str = "m",
                      spec: HopperSpec = H100, *, panels: int = 1,
                      b_bytes: int | None = None, a_ok: bool = True,
                      b_ok: bool = True, fp8: bool = False) -> list[GemmPlan]:
    """Candidates for the ragged grouped GEMM, scored by
    ``ragged_estimate``.  The per-group *mean* shape is classified: (rows,
    k, n) for the forward, (k, rows, n) for the dW (``ragged="k"``, whose
    contraction is the rows).  The forward offers every body
    ``ragged_bodies`` allows (``a_ok``: TMA reads x K-major; ``b_ok``: it
    reads the panels; the stream prices the min(g, total) panels ``total``
    rows can reach); the dW the tensor-core tiles where
    ``ragged_dw_bodies`` allows them (``a_ok`` / ``b_ok``: TMA reads x^T
    and dy MN-major; ``fp8``: 1-byte operands are fp8, not int8).  No
    grid-order choice: the ragged kernels fix their walk."""
    mean = max(total // max(g, 1), 1)
    cls = classify(mean, k, n) if ragged == "m" else classify(k, mean, n)
    b_bytes = b_bytes or in_bytes
    if ragged == "k":
        bodies, tc_tiles = (ragged_dw_bodies(in_bytes, b_bytes, a_ok, b_ok),
                            TC_TILES)
    else:
        bodies, tc_tiles = (ragged_bodies(in_bytes, b_bytes, total, a_ok,
                                          b_ok), (GROUP_TC_TILE,))
    price = functools.partial(ragged_estimate, g, total, k, n, in_bytes,
                              out_bytes, ragged, spec, panels=panels, fp8=fp8)
    cands = []
    for body in bodies:
        if body == "stream":
            cands += _stream_candidates(cls, price, k, GSTREAM_ROWS, False)
            continue
        cands += _candidates(cls, price, spec, orders=("mn",),
                             tiles=(tc_tiles if body == "tc"
                                    else fma_tiles(in_bytes, b_bytes)),
                             body=body)
    return cands


def _better(a: GemmPlan, b: GemmPlan) -> bool:
    ta, tb = a.est.t_total, b.est.t_total
    if abs(ta - tb) > 0.02 * max(ta, tb):
        return ta < tb
    # Tie-break as the paper does: prefer the fused epilogue (fewer device
    # memory round trips), the longer K step (more accumulator reuse per
    # sync), then less padded compute.
    if a.fuse != b.fuse:
        return a.fuse
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


def shortlist(cands: list[GemmPlan], top_k: int) -> list[GemmPlan]:
    """The model-pruned search space the measured auto-tuner times: the
    analytic argmin first (so a measured winner can never lose to it in
    the same run), then the next-best candidates by modeled time."""
    best = argmin_plan(cands)
    ordered = [best] + sorted(
        (c for c in cands if c is not best),
        key=lambda c: (c.est.t_total, c.est.flops_padded))
    seen: set[tuple] = set()
    out: list[GemmPlan] = []
    for c in ordered:
        sig = (c.body, c.bm, c.bn, c.bk, c.kslices, c.nsplit, c.dim_order,
               c.fuse)
        if sig in seen:
            continue
        seen.add(sig)
        out.append(c)
        if len(out) >= max(top_k, 1):
            break
    return out


# ---------------------------------------------------------------------------
# The measured plan store: keys, calibration, and records matched against
# the call's candidates (a record can suggest a plan, never force one).
# ---------------------------------------------------------------------------

def effective_spec(spec: HopperSpec) -> HopperSpec:
    """The default spec under the store's calibration, when the store has
    one fitted against it (``autotune.calibrate``), so shapes never
    measured plan against the card's achieved rates.  Any other spec, and a
    calibration fitted against another spec (the reference's ``tpu_v5e``),
    leave ``spec`` as it is."""
    if spec is not H100:
        return spec
    cal = plan_store.get_store().calibration
    if cal is None or cal.base_spec != H100.name:
        return spec
    return spec.calibrated(cal.flops_frac, cal.bw_frac, cal.flops_frac_int8)


def key_extra(base: str = "", *, in_bytes: int | None = None,
              b_bytes: int | None = None, panels: int = 1,
              a_ok: bool = True, b_ok: bool = True,
              a_major: str | None = "k", trans: str = "nn",
              fp8: bool = False) -> str:
    """The store key's variant fragments joined with "+": the reference's
    ``base`` ("shared:..." / "ragged:...") and mixed width ``bb{n}`` (B's
    width when it differs from A's), then the port's: ``pair`` (the SwiGLU
    kernels, ``panels`` = 2), the operand-layout flags that gate TMA when
    they are not the default (``a_ok:0``, ``b_ok:0``, ``a_major:mn`` /
    ``a_major:none``), ``trans:tn`` / ``trans:nt`` (the layout the winner
    was timed in) and ``fp8`` (1-byte operands that are fp8: the tuner
    times int8, so its records are not theirs).  A call with none of these
    keeps the reference's key."""
    frags = [base] if base else []
    if b_bytes is not None and b_bytes != in_bytes:
        frags.append(f"bb{int(b_bytes)}")
    if panels == 2:
        frags.append("pair")
    if not a_ok:
        frags.append("a_ok:0")
    if not b_ok:
        frags.append("b_ok:0")
    if a_major != "k":
        frags.append(f"a_major:{str(a_major).lower()}")
    if trans != "nn":
        frags.append(f"trans:{trans}")
    if fp8:
        frags.append("fp8")
    return "+".join(frags)


def dense_key(m, k, n, in_bytes, out_bytes, *, panels=1, b_bytes=None,
              a_ok=True, b_ok=True, trans="nn", fp8=False) -> str:
    return plan_store.shape_key("dense", (m, k, n), in_bytes, out_bytes,
                                extra=key_extra(in_bytes=in_bytes,
                                                b_bytes=b_bytes,
                                                panels=panels, a_ok=a_ok,
                                                b_ok=b_ok, trans=trans,
                                                fp8=fp8))


def batched_key(g, m, k, n, in_bytes, out_bytes, shared="none", *,
                panels=1, b_bytes=None, a_major="k", b_ok=True,
                trans="nn") -> str:
    return plan_store.shape_key(
        "batched", (g, m, k, n), in_bytes, out_bytes,
        extra=key_extra(f"shared:{shared}", in_bytes=in_bytes,
                        b_bytes=b_bytes, panels=panels, a_major=a_major,
                        b_ok=b_ok, trans=trans))


def ragged_key(g, total, k, n, in_bytes, out_bytes, ragged="m", *,
               panels=1, b_bytes=None, a_ok=True, b_ok=True,
               trans="nn", fp8=False) -> str:
    return plan_store.shape_key(
        "ragged", (g, total, k, n), in_bytes, out_bytes,
        extra=key_extra(f"ragged:{ragged}", in_bytes=in_bytes,
                        b_bytes=b_bytes, panels=panels, a_ok=a_ok,
                        b_ok=b_ok, trans=trans, fp8=fp8))


def _plan_from_record(rec: dict, cands: list[GemmPlan],
                      split_ok: bool = False) -> GemmPlan | None:
    """The candidate a stored record names (body, tile, grid order, K
    slices), tagged ``mode == "cached"`` with the record's split count and
    fusion; None when the record names no candidate of this call (a body
    its operands do not allow, a tile not compiled, too much shared
    memory) or a split count the call cannot take (``split_ok``: the
    dense one-panel product on the FMA or tensor-core body)."""
    try:
        want = (str(rec.get("body", "fma")), int(rec["bm"]), int(rec["bn"]),
                int(rec["bk"]), str(rec.get("dim_order", "mn")),
                int(rec.get("kslices", 1)))
        nsplit = int(rec.get("nsplit", 1))
        fuse = bool(rec.get("fuse", True))
    except (KeyError, TypeError, ValueError):
        return None
    if rec.get("edge", "masked") != "masked" or nsplit < 1:
        return None
    if nsplit > 1 and not (split_ok and want[0] in ("fma", "tc")):
        return None
    for c in cands:
        if (c.body, c.bm, c.bn, c.bk, c.dim_order, c.kslices) == want:
            return replace(c, nsplit=nsplit, fuse=fuse, mode="cached")
    return None


def _cached(key: str, cands: list[GemmPlan],
            split_ok: bool = False) -> GemmPlan | None:
    rec = plan_store.get_store().lookup(key)
    return None if rec is None else _plan_from_record(rec, cands, split_ok)


def _cached_dense(m, k, n, in_bytes, out_bytes, cands, **flags):
    return _cached(dense_key(m, k, n, in_bytes, out_bytes, **flags), cands,
                   split_ok=flags.get("panels", 1) == 1)


def _cached_batched(g, m, k, n, in_bytes, out_bytes, shared, cands, **flags):
    return _cached(batched_key(g, m, k, n, in_bytes, out_bytes, shared,
                               **flags), cands)


def _cached_ragged(g, total, k, n, in_bytes, out_bytes, ragged, cands,
                   **flags):
    return _cached(ragged_key(g, total, k, n, in_bytes, out_bytes, ragged,
                              **flags), cands)


@functools.lru_cache(maxsize=8192)
def plan_gemm(m: int, k: int, n: int, in_bytes: int = 4, out_bytes: int = 4,
              spec: HopperSpec = H100, *, panels: int = 1,
              b_bytes: int | None = None, a_ok: bool = True,
              b_ok: bool = True, trans: str = "nn",
              fp8: bool = False) -> GemmPlan:
    """Pick the body and tile for C(M,N) = op(A)(M,K) op(B)(K,N): a
    measured record for the signature when the store has one
    (``mode == "cached"``), else the CMR argmin.  ``in_bytes`` /
    ``b_bytes``: A's and B's element widths (B defaults to A's); ``a_ok`` /
    ``b_ok``: whether TMA can read each operand as laid out
    (``kernel.gemm_operands_ok``); ``trans``: the operands' layout, which
    keys the store (the analytic choice does not depend on it); ``fp8``:
    1-byte operands are fp8, not int8 (the price and the key).  The
    analytic plan always fuses the epilogue into the flush; a measured
    winner may not (``fuse``)."""
    spec = effective_spec(spec)
    cands = gemm_candidates(m, k, n, in_bytes, out_bytes, spec,
                            panels=panels, b_bytes=b_bytes, a_ok=a_ok,
                            b_ok=b_ok, fp8=fp8)
    return _cached_dense(m, k, n, in_bytes, out_bytes, cands, panels=panels,
                         b_bytes=b_bytes, a_ok=a_ok, b_ok=b_ok,
                         trans=trans, fp8=fp8) or argmin_plan(cands)


@functools.lru_cache(maxsize=8192)
def plan_batched_gemm(g: int, m: int, k: int, n: int, in_bytes: int = 4,
                      out_bytes: int = 4, shared: str = "none",
                      spec: HopperSpec = H100, *, panels: int = 1,
                      b_bytes: int | None = None, a_major: str | None = "k",
                      b_ok: bool = True, trans: str = "nn") -> GemmPlan:
    """Pick the body and tile for the grouped GEMM C(g) = A(g) B(g), from
    the store first (as ``plan_gemm``); ``shared`` marks a 2-D operand
    used by every group ("a" | "b" | "none"); ``panels`` = 2 plans the
    grouped SwiGLU pair; ``b_bytes``, ``a_major`` and ``b_ok`` as for
    ``batched_candidates`` (``kernel.grouped_operands`` gives the last
    two); ``trans`` keys the store."""
    spec = effective_spec(spec)
    cands = batched_candidates(g, m, k, n, in_bytes, out_bytes, shared, spec,
                               panels=panels, b_bytes=b_bytes,
                               a_major=a_major, b_ok=b_ok)
    return _cached_batched(g, m, k, n, in_bytes, out_bytes, shared, cands,
                           panels=panels, b_bytes=b_bytes, a_major=a_major,
                           b_ok=b_ok, trans=trans) or argmin_plan(cands)


@functools.lru_cache(maxsize=8192)
def plan_ragged_gemm(g: int, total: int, k: int, n: int, in_bytes: int = 4,
                     out_bytes: int = 4, ragged: str = "m",
                     spec: HopperSpec = H100, *, panels: int = 1,
                     b_bytes: int | None = None, a_ok: bool = True,
                     b_ok: bool = True, trans: str = "nn",
                     fp8: bool = False) -> GemmPlan:
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
    ``b_bytes`` is dy's width (defaults to x's).  The store is consulted
    first, as in ``plan_gemm`` (``trans``: the forward's "nn" or the dX's
    "nt" keys it; ``fp8`` as for ``plan_gemm``)."""
    spec = effective_spec(spec)
    cands = ragged_candidates(g, total, k, n, in_bytes, out_bytes, ragged,
                              spec, panels=panels, b_bytes=b_bytes,
                              a_ok=a_ok, b_ok=b_ok, fp8=fp8)
    return _cached_ragged(g, total, k, n, in_bytes, out_bytes, ragged, cands,
                          panels=panels, b_bytes=b_bytes, a_ok=a_ok,
                          b_ok=b_ok, trans=trans,
                          fp8=fp8) or argmin_plan(cands)


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
DEGRADED_COUNTS: collections.Counter = collections.Counter()


def note_plan_use(family: str, plan: GemmPlan) -> None:
    """Dispatch calls this each time a plan reaches an engine, keyed
    (family, mode)."""
    PLAN_MODE_COUNTS[(family, plan.mode)] += 1


def note_epilogue(family: str, fused: bool) -> None:
    """Dispatch calls this for each GEMM that carries an epilogue."""
    EPILOGUE_COUNTS[(family, "fused" if fused else "separate")] += 1


def note_degraded(family: str, rung: str) -> None:
    """Dispatch calls this when a rung of its ladder serves a GEMM whose
    primary launch failed (injected or real), keyed (family, rung), e.g.
    ``("dense", "fused->unfused")``: the serve engine's ``health()``
    reports degraded mode from it."""
    DEGRADED_COUNTS[(family, rung)] += 1


def degraded_stats() -> dict[str, int]:
    """{"family:rung": count} census of degraded servings (empty: every
    planned GEMM ran as planned)."""
    return {f"{family}:{rung}": count
            for (family, rung), count in sorted(DEGRADED_COUNTS.items())}


def epilogue_stats() -> dict[str, dict[str, int]]:
    """{family: {"fused"|"separate": count}} census of epilogue servings."""
    out: dict[str, dict[str, int]] = {}
    for (family, kind), count in sorted(EPILOGUE_COUNTS.items()):
        out.setdefault(family, {})[kind] = count
    return out


def plan_mode_stats() -> dict[str, dict[str, int]]:
    """{family: {mode: count}} census of plans that reached an engine, plus
    a per-family ``"quarantined"`` count of the store's records refused at
    load (those shapes plan analytically), an ``"epilogue"`` entry with
    fused-vs-separate totals when any GEMM carried an epilogue, and a
    ``"degraded"`` entry (``degraded_stats``) when a rung served one."""
    out: dict[str, dict[str, int]] = {}
    for (family, mode), count in sorted(PLAN_MODE_COUNTS.items()):
        out.setdefault(family, {})[mode] = count
    for key in plan_store.get_store().quarantined:
        fam = out.setdefault(key.split("|", 1)[0], {})
        fam["quarantined"] = fam.get("quarantined", 0) + 1
    epi: dict[str, int] = {}
    for (_family, kind), count in EPILOGUE_COUNTS.items():
        epi[kind] = epi.get(kind, 0) + count
    if epi:
        out["epilogue"] = dict(sorted(epi.items()))
    if DEGRADED_COUNTS:
        out["degraded"] = degraded_stats()
    return out


def clear_plan_cache() -> None:
    """Reset every plan-serving layer: the planner caches, the in-memory
    plan store (the file is untouched), the telemetry counters and the
    dispatch ladder's warn-once state."""
    clear_planner_caches()
    PLAN_MODE_COUNTS.clear()
    EPILOGUE_COUNTS.clear()
    DEGRADED_COUNTS.clear()
    plan_store.reset_store()
    from . import dispatch       # dispatch imports the tuner
    dispatch._WARNED_RUNGS.clear()


def clear_planner_caches() -> None:
    """Invalidate only the planner caches: the reset after the store gains
    records or a calibration, so that the next ``plan_*`` consults it."""
    plan_gemm.cache_clear()
    plan_batched_gemm.cache_clear()
    plan_ragged_gemm.cache_clear()
    plan_moe_dispatch.cache_clear()
