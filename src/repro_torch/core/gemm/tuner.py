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
(``effective_spec``).

Placed on a mesh (``num_shards`` > 1), a plan also carries a ``Placement``:
the paper's strategy lifted to the ranks -- m_parallel (Alg. 4: rows
sharded, panels replicated, no collective), k_parallel (Alg. 5: the
contraction sharded, the fp32 partials reduced over the links) or
expert_parallel (the group dim sharded, the tokens exchanged) -- with its
modeled interconnect term (``cmr.estimate_ep`` for the exchange, the ring
all-reduce for K-parallel, both over the H100's NVLink) and its overlap
``schedule`` ("gather": collective then product, times summed; "ring":
chunks rotate while the next is computed, times maxed).  The candidate
layouts are ``PlacementOption``s; the first (collective-free) one is
preferred and a challenger must beat it by its margin (``_select_placed``,
the paper's "clear modeled win").  Strategy and local tile are one
decision: the placed plan's tile is the local shard's.
``preferred_ep_schedule`` is what the EP executors ask when no schedule is
forced.  ``plan_moe_dispatch`` sizes an MoE layer's expert GEMM rows and
holds the capacity rounding rule that decides which tokens drop.
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
from .cmr import (H100, HopperSpec, PlanEstimate, cdiv, ceil_to, estimate,
                  estimate_batched, estimate_ep, estimate_group_stream,
                  estimate_ragged, estimate_stream, with_epilogue)
from .shapes import GemmClass, classify


@dataclass(frozen=True)
class Placement:
    """Where a plan runs on the mesh (None placement: one device).

    ``strategy``: "m_parallel" (Alg. 4: shard the rows, replicate the
    panels, no steady-state collective), "k_parallel" (Alg. 5: shard the
    contraction, reduce the fp32 partials) or "expert_parallel" (shard the
    group dim, exchange the tokens with their owning rank and back).
    ``t_collective`` is the modeled NVLink term of that choice,
    ``link_bytes`` the global bytes it moves, ``waste`` the load-imbalance
    multiplier on the local estimate.  ``schedule`` "gather" runs the
    collective and the local product back to back (``t_total`` sums them),
    "ring" rotates chunks so each hop's transfer overlaps the next chunk's
    product (``t_total`` takes the max)."""
    strategy: str
    num_shards: int = 1
    axis: str | None = None         # the mesh axis (advisory; executors bind)
    t_collective: float = 0.0
    link_bytes: float = 0.0
    waste: float = 1.0
    schedule: str = "gather"


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
    placement: Placement | None = None

    @property
    def t_total(self) -> float:
        """The local estimate, composed with the placement's collective
        term: x waste + collective ("gather"), max of the two ("ring")."""
        t = self.est.t_total if self.est is not None else 0.0
        p = self.placement
        if p is not None:
            if p.schedule == "ring":
                t = max(t * p.waste, p.t_collective)
            else:
                t = t * p.waste + p.t_collective
        return t

    @property
    def strategy(self) -> str:
        return self.placement.strategy if self.placement is not None \
            else "single"

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


# ---------------------------------------------------------------------------
# Placement options: the cross-rank layouts each family chooses between,
# with their modeled NVLink and waste terms.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlacementOption:
    """One candidate cross-rank layout: the per-shard local problem
    (``local_dims`` in the family's positional order), the modeled
    ``Placement``, and the margin a challenger must beat the preferred
    (first, collective-free) option by -- the paper's "clear modeled win"
    rule for accepting a reduction or exchange."""
    family: str
    local_dims: tuple
    placement: Placement
    margin: float = 1.0
    extra: str = ""

    def candidates(self, in_bytes: int, out_bytes: int,
                   spec: HopperSpec) -> list[GemmPlan]:
        """The local problem's candidates (the store's records match
        against them)."""
        if self.family == "dense":
            return gemm_candidates(*self.local_dims, in_bytes, out_bytes,
                                   spec)
        if self.family == "batched":
            return batched_candidates(*self.local_dims, in_bytes, out_bytes,
                                      self.extra, spec)
        return ragged_candidates(*self.local_dims, in_bytes, out_bytes,
                                 self.extra, spec)

    def plan_local(self, in_bytes: int, out_bytes: int,
                   spec: HopperSpec) -> GemmPlan:
        if self.family == "dense":
            return plan_gemm(*self.local_dims, in_bytes, out_bytes, spec)
        if self.family == "batched":
            return plan_batched_gemm(*self.local_dims, in_bytes, out_bytes,
                                     self.extra, spec)
        return plan_ragged_gemm(*self.local_dims, in_bytes, out_bytes,
                                self.extra, spec)


def _ring_allreduce_bytes(m: int, n: int, nc: int) -> float:
    """Bytes one rank sends in a ring all-reduce of an (m, n) fp32 array."""
    return 2.0 * (nc - 1) / nc * m * n * 4


def dense_placement_options(m: int, k: int, n: int, nc: int,
                            in_bytes: int = 4, out_bytes: int = 4,
                            spec: HopperSpec = H100,
                            axis: str | None = None) -> list[PlacementOption]:
    """M-parallel vs K-parallel across ``nc`` ranks (paper Alg. 4 vs 5).
    M-parallel shards M (a waste term when M does not fill the ranks) with
    no steady-state collective.  K-parallel shards K and reduces the fp32
    partials -- a ring all-reduce over NVLink -- so it must win by a clear
    margin (paper Sec. IV-C: K-parallel "brings additional overhead of
    reduction"), under both schedules: "gather" (product, then the
    reduction: times summed) and "ring" (output chunks rotate while the
    next chunk's partial is computed: the same bytes, times maxed).  The
    reference rounds the local M to its TPU sublane and K to its 128-lane
    panel; the H100's kernels mask both edges, so the local extents are
    the exact quotients."""
    m_local = max(cdiv(m, nc), 1)
    waste_m = (cdiv(m, nc) * nc) / max(m, 1)
    opts = [PlacementOption(
        "dense", (m_local, k, n),
        Placement("m_parallel", nc, axis=axis, waste=waste_m))]
    k_local = max(cdiv(k, nc), 1)
    sent = _ring_allreduce_bytes(m, n, nc)
    for schedule in ("ring", "gather"):
        opts.append(PlacementOption(
            "dense", (m, k_local, n),
            Placement("k_parallel", nc, axis=axis,
                      t_collective=sent / spec.link_bw,
                      link_bytes=sent * nc, schedule=schedule),
            margin=1.15))
    return opts


def batched_placement_options(g: int, m: int, k: int, n: int, nc: int,
                              in_bytes: int = 4, out_bytes: int = 4,
                              shared: str = "none", spec: HopperSpec = H100,
                              axis: str | None = None
                              ) -> list[PlacementOption]:
    """Per-entry m_parallel (rows sharded, every rank streams all G panels)
    vs expert_parallel (the G dim sharded, the tokens exchanged with their
    owning rank and back, priced by ``estimate_ep``); EP must amortize its
    exchange before it displaces the collective-free layout."""
    m_l = max(cdiv(m, nc), 1)
    waste_m = (cdiv(m, nc) * nc) / max(m, 1)
    opts = [PlacementOption(
        "batched", (g, m_l, k, n),
        Placement("m_parallel", nc, axis=axis, waste=waste_m), extra=shared)]
    g_l = max(cdiv(g, nc), 1)
    ex = (estimate_ep(g * m, k, nc, elt_bytes=in_bytes, spec=spec)
          + estimate_ep(g * m, n, nc, elt_bytes=out_bytes, spec=spec))
    opts.append(PlacementOption(
        "batched", (g_l, m, k, n),
        Placement("expert_parallel", nc, axis=axis,
                  t_collective=ex.t_exchange, link_bytes=ex.link_bytes,
                  waste=(g_l * nc) / max(g, 1)),
        margin=1.1, extra=shared))
    return opts


def ragged_placement_options(g: int, total: int, k: int, n: int, nc: int,
                             in_bytes: int = 4, out_bytes: int = 4,
                             ragged: str = "m", spec: HopperSpec = H100,
                             axis: str | None = None
                             ) -> list[PlacementOption]:
    """Token-parallel (rows sharded, panels replicated) vs expert-parallel
    (groups sharded plus the two exchange legs), EP under both schedules.
    EP "ring": token blocks rotate and each rank computes only the blocks
    that meet its owned window, priced as min(total, 2 x t_l) local rows
    with the rotation's bytes hidden behind them (times maxed).  EP
    "gather": the exchange, then ONE local product over the worst-case
    window -- every row could route to this rank's experts, so its local
    estimate prices all ``total`` rows.  The EP dW (``ragged`` "k")
    contracts rows that already live on the owning rank after the
    forward's exchange: expert-local, no collective, no alternative."""
    t_l = max(cdiv(total, nc), 1)
    g_l = max(cdiv(g, nc), 1)
    waste = (cdiv(total, nc) * nc) / max(total, 1)
    if ragged == "k":
        return [PlacementOption(
            "ragged", (g_l, t_l, k, n),
            Placement("expert_parallel", nc, axis=axis, waste=waste),
            extra="k")]
    opts = [PlacementOption(
        "ragged", (g, t_l, k, n),
        Placement("m_parallel", nc, axis=axis, waste=waste), extra="m")]
    # Ring: (nc - 1) x-block hops and nc output-block hops a rank.
    per_shard = (nc - 1) * t_l * k * in_bytes + nc * t_l * n * out_bytes
    opts.append(PlacementOption(
        "ragged", (g_l, min(total, 2 * t_l), k, n),
        Placement("expert_parallel", nc, axis=axis,
                  t_collective=per_shard / spec.link_bw,
                  link_bytes=float(per_shard) * nc, waste=waste,
                  schedule="ring"),
        margin=1.1, extra="m"))
    ex = (estimate_ep(total, k, nc, elt_bytes=in_bytes, spec=spec)
          + estimate_ep(total, n, nc, elt_bytes=out_bytes, spec=spec))
    opts.append(PlacementOption(
        "ragged", (g_l, total, k, n),
        Placement("expert_parallel", nc, axis=axis,
                  t_collective=ex.t_exchange, link_bytes=ex.link_bytes,
                  waste=waste),
        margin=1.1, extra="m"))
    return opts


def _select_placed(scored: list[tuple[PlacementOption, GemmPlan]]
                   ) -> GemmPlan:
    """The first (collective-free) option is preferred; a challenger must
    beat it by its margin (the paper's "clear modeled win" rule)."""
    best = scored[0][1]
    for opt, cand in scored[1:]:
        if cand.t_total * opt.margin < best.t_total:
            best = cand
    return best


def _placed(family: str, dims: tuple, in_bytes: int, out_bytes: int,
            num_shards: int, options: list[PlacementOption],
            spec: HopperSpec, extra: str = "") -> GemmPlan:
    """The placed plan: a measured record under the ``|shardsN`` key when
    the store has one whose strategy, schedule and local tile name an
    option's candidate (``mode`` "cached"), else the analytic choice among
    the options' local argmins."""
    rec = plan_store.get_store().lookup(plan_store.shape_key(
        family, dims, in_bytes, out_bytes, num_shards=num_shards,
        extra=extra))
    if rec is not None:
        for opt in options:
            if (opt.placement.strategy != rec.get("strategy")
                    or opt.placement.schedule
                    != rec.get("schedule", "gather")):
                continue
            local = _plan_from_record(
                rec, opt.candidates(in_bytes, out_bytes, spec))
            if local is not None:
                return replace(local, placement=opt.placement)
            break
    return _select_placed([(o, replace(o.plan_local(in_bytes, out_bytes,
                                                    spec),
                                       placement=o.placement))
                           for o in options])


@functools.lru_cache(maxsize=4096)
def preferred_ep_schedule(g: int, total: int, k: int, n: int,
                          in_bytes: int = 4, out_bytes: int = 4,
                          num_shards: int = 1, spec: HopperSpec = H100,
                          serial: int = 1) -> str:
    """Which EP schedule the model prefers for this ragged shape, "ring"
    or "gather": what the EP executors take when the caller forces none.
    ``serial`` multiplies every option's LOCAL term: the number of ranks
    whose local products share one device and so run one after another
    (the executors read it from the mesh: on a CPU gloo world or with two
    ranks on one card it is the shard count; with a GPU a rank it is 1).
    There the gather schedule's full-window product serializes over the
    ranks while the ring's owned-rows-only product does not."""
    if num_shards <= 1:
        return "gather"
    spec = effective_spec(spec)
    best_t, best_s = float("inf"), "gather"
    for o in ragged_placement_options(g, total, k, n, num_shards, in_bytes,
                                      out_bytes, "m", spec):
        if o.placement.strategy != "expert_parallel":
            continue
        local = (o.plan_local(in_bytes, out_bytes, spec).est.t_total
                 * o.placement.waste * max(1, serial))
        t = (max(local, o.placement.t_collective)
             if o.placement.schedule == "ring"
             else local + o.placement.t_collective)
        if t < best_t:
            best_t, best_s = t, o.placement.schedule
    return best_s


@dataclass(frozen=True)
class DistPlan:
    """The dense placed plan as the reference's compat view: ``local`` is
    the per-shard ``GemmPlan``; the strategy and the costs read through to
    its ``Placement``."""
    local: GemmPlan
    placement: Placement
    mode: str = "analytic"

    @property
    def est(self) -> PlanEstimate | None:
        return self.local.est

    @property
    def t_total(self) -> float:
        return self.local.t_total

    @property
    def strategy(self) -> str:
        return self.placement.strategy

    @property
    def num_cores(self) -> int:
        return self.placement.num_shards

    @property
    def t_collective(self) -> float:
        return self.placement.t_collective


@functools.lru_cache(maxsize=8192)
def plan_distributed(m: int, k: int, n: int, num_cores: int,
                     in_bytes: int = 4, out_bytes: int = 4,
                     spec: HopperSpec = H100) -> DistPlan:
    """M-parallel vs K-parallel across ``num_cores`` ranks: the dense-only
    entry point (``plan_gemm(..., num_shards=n)`` is the unified spelling
    and returns the same placed plan).  A single-rank request still gets
    an (m_parallel, 1 shard) placement, so ``strategy`` always reads."""
    spec = effective_spec(spec)
    nc = max(num_cores, 1)
    p = _placed("dense", (m, k, n), in_bytes, out_bytes, nc,
                dense_placement_options(m, k, n, nc, in_bytes, out_bytes,
                                        spec), spec)
    return DistPlan(local=p, placement=p.placement, mode=p.mode)


@functools.lru_cache(maxsize=8192)
def plan_gemm(m: int, k: int, n: int, in_bytes: int = 4, out_bytes: int = 4,
              spec: HopperSpec = H100, *, panels: int = 1,
              b_bytes: int | None = None, a_ok: bool = True,
              b_ok: bool = True, trans: str = "nn",
              fp8: bool = False, num_shards: int = 1,
              axis: str | None = None) -> GemmPlan:
    """Pick the body and tile for C(M,N) = op(A)(M,K) op(B)(K,N): a
    measured record for the signature when the store has one
    (``mode == "cached"``), else the CMR argmin.  ``in_bytes`` /
    ``b_bytes``: A's and B's element widths (B defaults to A's); ``a_ok`` /
    ``b_ok``: whether TMA can read each operand as laid out
    (``kernel.gemm_operands_ok``); ``trans``: the operands' layout, which
    keys the store (the analytic choice does not depend on it); ``fp8``:
    1-byte operands are fp8, not int8 (the price and the key).  The
    analytic plan always fuses the epilogue into the flush; a measured
    winner may not (``fuse``).  ``num_shards`` > 1 places the product on
    ``axis`` of a mesh too: the plan is the winning layout's local tile
    with its ``Placement`` (m_parallel vs k_parallel; the layout flags then
    take their defaults, as the executors' local products do)."""
    spec = effective_spec(spec)
    if num_shards > 1:
        return _placed("dense", (m, k, n), in_bytes, out_bytes, num_shards,
                       dense_placement_options(m, k, n, num_shards, in_bytes,
                                               out_bytes, spec, axis), spec)
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
                      b_ok: bool = True, trans: str = "nn",
                      num_shards: int = 1,
                      axis: str | None = None) -> GemmPlan:
    """Pick the body and tile for the grouped GEMM C(g) = A(g) B(g), from
    the store first (as ``plan_gemm``); ``shared`` marks a 2-D operand
    used by every group ("a" | "b" | "none"); ``panels`` = 2 plans the
    grouped SwiGLU pair; ``b_bytes``, ``a_major`` and ``b_ok`` as for
    ``batched_candidates`` (``kernel.grouped_operands`` gives the last
    two); ``trans`` keys the store.  ``num_shards`` > 1: per-entry
    m_parallel vs expert_parallel on ``axis``."""
    spec = effective_spec(spec)
    if num_shards > 1:
        return _placed("batched", (g, m, k, n), in_bytes, out_bytes,
                       num_shards, batched_placement_options(
                           g, m, k, n, num_shards, in_bytes, out_bytes,
                           shared, spec, axis), spec,
                       extra=f"shared:{shared}")
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
                     fp8: bool = False, num_shards: int = 1,
                     axis: str | None = None) -> GemmPlan:
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
    "nt" keys it; ``fp8`` as for ``plan_gemm``).  ``num_shards`` > 1:
    token-parallel vs expert-parallel (both schedules) on ``axis``; the dW
    is expert-local."""
    spec = effective_spec(spec)
    if num_shards > 1:
        return _placed("ragged", (g, total, k, n), in_bytes, out_bytes,
                       num_shards, ragged_placement_options(
                           g, total, k, n, num_shards, in_bytes, out_bytes,
                           ragged, spec, axis), spec,
                       extra=f"ragged:{ragged}")
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
    that price the rows).  The reference's ``num_shards`` here is not
    ported: the expert GEMMs' placement is ``plan_ragged_gemm`` /
    ``plan_batched_gemm(num_shards=)``'s."""
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
    plan store (the file is untouched), the telemetry counters, the
    dispatch ladder's warn-once state and its ``REPRO_VERIFY`` memo (the
    variable read again)."""
    clear_planner_caches()
    PLAN_MODE_COUNTS.clear()
    EPILOGUE_COUNTS.clear()
    DEGRADED_COUNTS.clear()
    plan_store.reset_store()
    from . import dispatch       # dispatch imports the tuner
    dispatch._WARNED_RUNGS.clear()
    dispatch.reset_verify()


def clear_planner_caches() -> None:
    """Invalidate only the planner caches: the reset after the store gains
    records or a calibration, so that the next ``plan_*`` consults it."""
    plan_gemm.cache_clear()
    plan_batched_gemm.cache_clear()
    plan_ragged_gemm.cache_clear()
    plan_moe_dispatch.cache_clear()
    plan_distributed.cache_clear()
    preferred_ep_schedule.cache_clear()
