"""Static kernel contracts: prove a plan safe for the Hopper kernels before
any of them runs.

Every candidate the tuner generates (``analysis.sweep``), every stored
plan and (with ``REPRO_VERIFY=1``) every planned call is checked without
a launch:

  1. Budget -- one CTA's shared memory (``smem_footprint``, from the sizes
     the kernels are built with: ``kernel.smem_bytes`` for the FMA,
     tensor-core and register-stream bodies, ``kernel.gstream_smem`` for
     the group stream, ``TC_STAGES`` for the ring depth, ``STREAM_SMEM``
     for the staged rows) within ``HopperSpec.smem_per_block``.
  2. Store coverage -- the kernel's grid as its C entry launches it
     (``kernel.launch_grid``) is enumerated: a store does not move with
     the K slices that sum into it (the last CTA of a counter flushes),
     every store is in range, no two CTAs store one output tile, and every
     tile is stored.  The ragged forward kernels store the rows the device
     offsets give them: ``check_ragged_rows`` proves one writer per output
     row over adversarial offsets, the rows no group owns written (as
     zeros) by the extra slot of CTAs.
  3. Masking of the contraction remainder -- every body's K loop must send
     every operand (three for a SwiGLU pair) through a masked load, since
     0 x NaN = NaN: checked on the CUDA sources (``check_contraction_masking``).
  4. Plan invariants (``check_blocks``) -- the tile is one the body is
     compiled for, the stream's K slices fit the grid, the grid order is
     one the kernel walks, split-K is dense only, a 1-byte operand is on
     the FMA body only, every edge is masked; split-K with a fused
     nonlinear tail and a flush vector neither (N,) nor (G, N) are
     violations (``check_schedule``, ``check_epilogue_vectors``).

  5. Placement (``check_placement``) -- a placed plan's strategy and
     schedule are ones the mesh executors run: expert parallelism needs
     the group count divisible by the shard count (as
     ``launch.sharding.expert_axis`` rules), the ring schedule exists only
     for dense k_parallel and ragged expert_parallel, and k_parallel should
     leave every shard at least one tensor-core K step (a warning).  A
     store key with ``|shardsN`` is held to these rules and to a tile the
     body is compiled for; its local shape is the option's, not the key's,
     so no shape check applies to it.

This module imports nothing of ``core.gemm`` at module level (``dispatch``
and ``plan_store`` import it); the device spec is resolved when a check
needs it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from ..kernels.ftimm import kernel as K
from ..kernels.ftimm import ref as _ref

FAMILIES = ("dense", "batched", "ragged")
STRATEGIES = ("m_parallel", "k_parallel", "expert_parallel")
SCHEDULES = ("gather", "ring")
# The (family, strategy) pairs with an overlapped ring schedule: dense
# K-parallel (``collective.ring_kparallel``) and ragged EP
# (``collective.ring_forward`` / ``ring_backward``).
_RING_LEGAL = {("dense", "k_parallel"), ("ragged", "expert_parallel")}
_NDIMS = {"dense": 3, "batched": 4, "ragged": 4}
_ORDERS = ("mn", "nm")
# The kernels with a compiled 1-byte (quantized) type code, on their FMA
# body (kernel._QUANT): their FMA tile menu is ``fma_tiles``.
_NARROW_KERNELS = ("ftimm_gemm", "ftimm_gemm_ragged")


def _cdiv(x: int, b: int) -> int:
    return -(-x // b)


def _spec(spec: Any) -> Any:
    """The device spec (needs ``.smem_per_block``); defaults to the H100."""
    if spec is not None:
        return spec
    from ..core.gemm.cmr import H100
    return H100


@dataclass(frozen=True)
class Violation:
    """One broken contract.  ``severity == "error"`` means the plan must not
    run; warnings are report-only."""
    code: str
    message: str
    severity: str = "error"

    def __str__(self) -> str:
        return f"[{self.severity}] {self.code}: {self.message}"


class ContractError(AssertionError):
    """Raised by ``assert_plan`` (the ``REPRO_VERIFY=1`` dispatch mode) and
    by a malformed flush vector."""

    def __init__(self, violations: Sequence[Violation],
                 context: str = "") -> None:
        self.violations = tuple(violations)
        head = f"kernel contract violated for {context}: " if context else \
            "kernel contract violated: "
        super().__init__(head + "; ".join(str(v) for v in self.violations))


def errors(violations: Iterable[Violation]) -> list[Violation]:
    """Only the fatal subset."""
    return [v for v in violations if v.severity == "error"]


def plan_kernel(family: str, *, panels: int = 1, nsplit: int = 1,
                ragged: str = "m") -> str:
    """The kernel a plan of ``family`` launches: ``ftimm_gemm`` (its split-K
    kernel when ``nsplit`` > 1) and the dense pair, the grouped kernel and
    its pair, the ragged kernel and its pair, or the ragged dW
    (``ragged`` "k")."""
    pair = panels == 2
    if family == "dense":
        if pair:
            return "ftimm_gemm_swiglu"
        return "ftimm_gemm_splitk" if nsplit > 1 else "ftimm_gemm"
    if family == "batched":
        return "ftimm_gemm_grouped_swiglu" if pair else "ftimm_gemm_grouped"
    if ragged == "k":
        return "ftimm_gemm_ragged_dw"
    return "ftimm_gemm_ragged_swiglu" if pair else "ftimm_gemm_ragged"


# ---------------------------------------------------------------------------
# Contract 4: plan invariants
# ---------------------------------------------------------------------------

def _tile_compiled(kernel: str, body: str, bm: int, bn: int, bk: int,
                   widths: tuple[int, int]) -> bool:
    if body == "fma":
        menu = (K.fma_tiles(*widths) if kernel in _NARROW_KERNELS
                else K.TILES)
        return (bm, bn, bk) in menu
    if body == "tc":
        menu = (K.TC_TILES if kernel in ("ftimm_gemm", "ftimm_gemm_splitk",
                                         "ftimm_gemm_ragged_dw")
                else (K.GROUP_TC_TILE,))
        return (bm, bn, bk) in menu
    rows = ((K.GSTREAM_ROWS,) if kernel in K._GROUP_STREAM
            else K.STREAM_ROWS)
    return (bm in rows and bn == K.STREAM_STRIP
            and bk % K.STREAM_SLICE_STEP == 0)


def check_blocks(family: str, dims: Sequence[int], *, bm: int, bn: int,
                 bk: int, nsplit: int = 1, dim_order: str = "mn",
                 edge: str = "masked", in_bytes: int = 4, out_bytes: int = 4,
                 ragged: str = "m", body: str = "fma", kslices: int = 1,
                 panels: int = 1, b_bytes: int | None = None
                 ) -> list[Violation]:
    """The plan invariants of the Hopper bodies; cheap enough for the
    sweep to run on every candidate the tuner generates.  ``dims``:
    (M, K, N) dense, (G, M, K, N) batched, (G, T, K, N) ragged ((G, T, D,
    F) for the dW, ``ragged`` "k"); ``b_bytes``: B's width when it differs
    from A's; ``panels`` 2: a SwiGLU pair."""
    if family not in FAMILIES:
        return [Violation("bad_family", f"family {family!r} not in "
                                        f"{FAMILIES}")]
    if len(dims) != _NDIMS[family]:
        return [Violation("bad_dims", f"{family} wants {_NDIMS[family]} "
                                      f"dims, got {tuple(dims)}")]
    if min(bm, bn, bk) <= 0 or nsplit <= 0 or kslices <= 0:
        return [Violation("nonpositive_block",
                          f"bm={bm} bn={bn} bk={bk} nsplit={nsplit} "
                          f"kslices={kslices} must all be positive")]
    v: list[Violation] = []
    if edge != "masked":
        v.append(Violation(
            "edge_padded" if edge == "padded" else "bad_edge",
            f"edge={edge!r}: every Hopper body masks its edges; a padded "
            "plan's copies belong to the TPU kernels"))
    # The body and tile rules are the family kernel's; split-K shares
    # ftimm_gemm's FMA and tensor-core tiles.
    kernel = plan_kernel(family, panels=panels, ragged=ragged)
    if body not in K._BODY_KERNELS[kernel]:
        return v + [Violation("unknown_body", f"{kernel} has no {body!r} "
                                              "body")]
    if dim_order not in _ORDERS or (family == "ragged" and dim_order != "mn"):
        v.append(Violation(
            "bad_dim_order", f"dim_order={dim_order!r}: "
            + ("the ragged kernels walk 'mn' only" if family == "ragged"
               else f"not in {_ORDERS}")))
    if nsplit > 1:
        if kernel != "ftimm_gemm" or body == "stream":
            v.append(Violation("nsplit_invalid",
                               f"nsplit={nsplit}: split-K is the dense "
                               "one-panel product on the fma or tc body"))
        elif nsplit > _cdiv(max(dims[1], 1), bk):
            v.append(Violation(
                "unclamped_nsplit",
                f"nsplit={nsplit} exceeds the {_cdiv(max(dims[1], 1), bk)} "
                f"K blocks of bk={bk}: some splits would be empty"))
    widths = (int(in_bytes), int(b_bytes or in_bytes))
    if 1 in widths and body != "fma":
        v.append(Violation(
            "narrow_operand_body",
            f"a 1-byte operand runs on the FMA body only, not {kernel}'s "
            f"{body} body"))
    if not _tile_compiled(kernel, body, bm, bn, bk, widths):
        v.append(Violation("tile_not_compiled",
                           f"({bm}, {bn}, {bk}) is not a tile {kernel}'s "
                           f"{body} body is compiled for"))
    if body == "stream":
        k = dims[1] if family == "dense" else dims[2]
        _, slices = K.stream_slice(k, kslices)
        if slices > 65535:
            v.append(Violation("stream_slices_over_grid",
                               f"{slices} K slices exceed the grid's y "
                               "extent (65535)"))
        rows = dims[0] if family == "dense" else dims[1]
        cap = (K.GSTREAM_ROWS if kernel in K._GROUP_STREAM
               else K.STREAM_ROWS[-1])
        if rows > cap:
            v.append(Violation("stream_rows_exceeded",
                               f"{rows} rows (a group's, or the ragged "
                               f"call's in all) exceed the stream's {cap}"))
    return v


def smem_footprint(kernel: str, body: str, *, bm: int, bn: int, bk: int,
                   panels: int = 1) -> tuple[int, int]:
    """(shared memory of one CTA, bytes of staged activation rows) of
    ``kernel``'s ``body`` at a tile: the sizes the kernels are built with
    (``kernel.smem_bytes``, ``kernel.gstream_smem``, ``TC_STAGES``); only
    the register stream stages rows, which must fit ``STREAM_SMEM``."""
    if body == "fma":
        return K.smem_bytes(bm, bn, bk, panels), 0
    if body == "tc":
        return K.smem_bytes(bm, bn, bk, panels, body="tc",
                            stages=K.TC_STAGES[kernel]), 0
    if kernel in K._GROUP_STREAM:
        return K.gstream_smem(panels), 0
    return K.smem_bytes(bm, bn, bk, body="stream"), bm * bk * 2


def check_budget(kernel: str, body: str, *, bm: int, bn: int, bk: int,
                 panels: int = 1, spec: Any = None) -> list[Violation]:
    """Contract 1: one CTA's shared memory within a block's budget, and the
    register stream's staged rows within ``STREAM_SMEM``."""
    smem, staged = smem_footprint(kernel, body, bm=bm, bn=bn, bk=bk,
                                  panels=panels)
    budget = _spec(spec).smem_per_block
    if smem > budget or staged > K.STREAM_SMEM:
        return [Violation(
            "smem_over_budget",
            f"{kernel} {body} ({bm}, {bn}, {bk}): {smem} B of shared memory"
            f" (budget {budget} B), {staged} B of staged rows (budget "
            f"{K.STREAM_SMEM} B)")]
    return []


def check_schedule(*, nsplit: int = 1, fuse: bool = True, epilogue: Any = None,
                   swiglu: bool = False) -> list[Violation]:
    """Split-K with a nonlinear tail: a tail fused into each split's flush
    would apply the nonlinearity to partial sums (act(a+b) != act(a) +
    act(b)), so a split-K plan may fuse only a tail applied after the
    ordered sum.  A scale vector is linear and stays legal."""
    v: list[Violation] = []
    if nsplit <= 1:
        return v
    nonlinear = swiglu or (
        epilogue is not None
        and getattr(epilogue, "activation", "none") != "none")
    if fuse and nonlinear:
        v.append(Violation(
            "splitk_nonlinear_epilogue",
            f"nsplit={nsplit} with a fused nonlinear epilogue would apply "
            "the activation to partial sums"))
    if swiglu:
        v.append(Violation("splitk_unsupported",
                           "no split-K SwiGLU kernel exists"))
    return v


def check_epilogue_vectors(family: str, dims: Sequence[int], epilogue: Any,
                           *, bias_shape: Sequence[int] | None = None,
                           scale_shape: Sequence[int] | None = None
                           ) -> list[Violation]:
    """The flush vectors of one call, by the kernels' own rule
    (``kernel.vector_shapes``): (N,), broadcast over the rows, or for the
    grouped and ragged families (G, N), one row per group."""
    v: list[Violation] = []
    if epilogue is None:
        return v
    want = K.vector_shapes(int(dims[-1]), int(dims[0]) if family in (
        "batched", "ragged") else None)
    for name, flag, shape in (
            ("scale", getattr(epilogue, "scale_vec", False), scale_shape),
            ("bias", getattr(epilogue, "bias", False), bias_shape)):
        if flag and shape is not None and tuple(
                int(s) for s in shape) not in want:
            v.append(Violation(
                f"bad_{name}_shape",
                f"{family} epilogue {name} operand has shape "
                f"{tuple(shape)}; expected "
                + " or ".join(str(s) for s in want)))
    return v


# ---------------------------------------------------------------------------
# Contract 2: store coverage and write races over the launch grid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelContract:
    """What one launch promises about its stores, from ``kernel.launch_grid``.
    ``out_index_map(x, y, z)``: the output tile each CTA stores;
    ``arrival(x, y, z)``: (counter, K slice), the CTAs of a counter summing
    ``slices`` slices into one store."""
    name: str
    body: str
    grid: tuple[int, int, int]
    out_extent: tuple[int, ...]
    out_index_map: Callable
    arrival: Callable
    slices: int


def variant_contract(family: str, dims: Sequence[int], plan: Any, *,
                     swiglu: bool = False, ragged: str = "m"
                     ) -> KernelContract:
    """The store contract of the launch a plan makes.  The port's kernels
    take strided operands, so the grid is the same for every trans.  The
    ragged forward kernels store the rows the device offsets give them:
    ``check_ragged_rows``."""
    nsplit = int(getattr(plan, "nsplit", 1))
    body = getattr(plan, "body", "fma")
    kernel = plan_kernel(family, panels=2 if swiglu else 1, nsplit=nsplit,
                         ragged=ragged)
    tile = (int(plan.bm), int(plan.bn), int(plan.bk))
    lg = K.launch_grid(kernel, body, tuple(int(d) for d in dims), tile,
                       dim_order=getattr(plan, "dim_order", "mn"),
                       kslices=int(getattr(plan, "kslices", 1)),
                       nsplit=nsplit)
    if lg.store is None:
        raise ValueError(f"{kernel} stores the rows its offsets give it: "
                         "check_ragged_rows proves its stores")
    return KernelContract(kernel, body, lg.grid, lg.out_extent, lg.store,
                          lg.arrival, lg.slices)


def _axis(extent: int, cap: int) -> np.ndarray:
    """Boundary-biased sample of a grid axis: its first and last ``cap``
    indices and an even spread between."""
    if extent <= 3 * cap:
        return np.arange(extent)
    return np.unique(np.concatenate([
        np.arange(cap), np.arange(extent - cap, extent),
        np.linspace(0, extent - 1, cap, dtype=np.int64)]))


def verify_contract(contract: KernelContract, max_ctas: int = 1 << 22
                    ) -> list[Violation]:
    """Enumerate every CTA of the grid (a boundary-biased sample of each
    axis past ``max_ctas``, where coverage is not claimed): the stores of
    one counter's K slices must agree (``store_moves_with_reduction``),
    each counter must take each slice once, every store must be in range,
    no two counters may store one tile (``write_race``), and every tile
    must be stored (``coverage_gap``)."""
    v: list[Violation] = []

    def flag(code: str, msg: str) -> None:
        v.append(Violation(code, f"{contract.name} {contract.body}: {msg}"))

    gx, gy, gz = contract.grid
    ext = tuple(int(e) for e in contract.out_extent)
    if gx * gy * gz == 0:
        if int(np.prod(ext)):
            flag("coverage_gap", f"an empty grid stores none of {ext}")
        return v
    sampled = gx * gy * gz > max_ctas
    axes = ([_axis(a, 64) for a in contract.grid] if sampled
            else [np.arange(a) for a in contract.grid])
    x, y, z = (a.ravel() for a in np.meshgrid(*axes, indexing="ij"))
    key, sl = (np.broadcast_to(np.asarray(a, dtype=np.int64), x.shape)
               for a in contract.arrival(x, y, z))
    out = [np.broadcast_to(np.asarray(a, dtype=np.int64), x.shape)
           for a in contract.out_index_map(x, y, z)]
    if len(out) != len(ext):
        flag("out_of_range_store", f"stores {len(out)}-d tiles into a "
                                   f"{len(ext)}-d output")
        return v
    inside = np.ones(x.shape, dtype=bool)
    for o, e in zip(out, ext):
        inside &= (o >= 0) & (o < e)
    inside &= (sl >= 0) & (sl < contract.slices)
    if not inside.all():
        i = int(np.argmin(inside))
        flag("out_of_range_store",
             f"{int((~inside).sum())} CTAs store outside the {ext} tiles "
             f"(or a slice outside {contract.slices}), e.g. CTA "
             f"{(int(x[i]), int(y[i]), int(z[i]))} -> "
             f"{tuple(int(o[i]) for o in out)}")
    key, sl = key[inside], sl[inside]
    if not key.size:
        if not sampled and int(np.prod(ext)):
            flag("coverage_gap", f"no CTA stores any of the {ext} tiles")
        return v
    ntiles = int(np.prod(ext))
    flat = np.ravel_multi_index(tuple(o[inside] for o in out), ext)
    # (counter, tile) and (counter, slice) pairs, each packed in one int64.
    pairs = np.unique(key * ntiles + flat)
    ukeys, per_key = np.unique(pairs // ntiles, return_counts=True)
    if (per_key > 1).any():
        flag("store_moves_with_reduction",
             f"{int((per_key > 1).sum())} counters' K slices store different"
             f" tiles, e.g. counter {int(ukeys[np.argmax(per_key > 1)])}")
    arrivals = np.unique(key * contract.slices + sl)
    if arrivals.size != key.size:
        flag("write_race", f"{key.size - arrivals.size} CTAs repeat a "
                           "(counter, slice): one slice summed twice")
    tiles, writers = np.unique(pairs % ntiles, return_counts=True)
    if (writers > 1).any():
        t = int(tiles[np.argmax(writers > 1)])
        flag("write_race",
             f"{int((writers > 1).sum())} tiles are stored by more than one "
             f"counter, e.g. tile {np.unravel_index(t, ext)}: the last "
             "writer wins, in schedule order")
    if not sampled:
        _, slices_of = np.unique(arrivals // contract.slices,
                                 return_counts=True)
        if (slices_of < contract.slices).any():
            flag("coverage_gap",
                 f"{int((slices_of < contract.slices).sum())} counters get "
                 f"fewer than their {contract.slices} slices: never flushed")
        missing = ntiles - tiles.size
        if missing:
            stored = np.zeros(ntiles, dtype=bool)
            stored[tiles] = True
            first = int(np.argmin(stored))
            flag("coverage_gap",
                 f"{missing} of {ntiles} output tiles are never stored, e.g. "
                 f"{np.unravel_index(first, ext)}")
    return v


# Adversarial group distributions for the ragged one-writer proof, each
# (groups, rows) -> (offsets, T): balanced; all rows to one group;
# leading and inner empty groups; boundaries 7 rows apart (inside a tile);
# a single group; rows past offsets[G] that no group owns.
RAGGED_DISTS: tuple[tuple[str, Callable], ...] = (
    ("balanced", lambda g, t: ([t * i // g for i in range(g + 1)], t)),
    ("skewed", lambda g, t: ([0] + [t] * g, t)),
    ("empty groups", lambda g, t: ([0, 0] + [t * i // max(g - 1, 1)
                                             for i in range(1, g)], t)),
    ("boundary inside a tile",
     lambda g, t: ([min(7 * i, t) for i in range(g)] + [t], t)),
    ("one group", lambda g, t: ([0, t], t)),
    ("rows no group owns", lambda g, t: ([(t * 3 // 4) * i // g
                                          for i in range(g + 1)], t)),
)


def check_ragged_rows(offsets: Sequence[int], t: int | None = None, *,
                      kernel: str = "ftimm_gemm_ragged", body: str = "fma",
                      tile: Sequence[int] = K.TILES[0], kslices: int = 1,
                      grid: K.LaunchGrid | None = None) -> list[Violation]:
    """One writer per output row of the ragged forward ``kernel``'s
    ``body`` for these offsets (T = ``t`` rows, default offsets[G]): each
    row a group owns is written by exactly one CTA of that group, each row
    no group owns by exactly one CTA of the zero-fill slot, and nothing
    else (``grid``: the launch to prove, default ``kernel.launch_grid``'s).
    One column tile stands for all: every one is walked alike."""
    off = [int(x) for x in offsets]
    t = off[-1] if t is None and off else t
    if (not off or off[0] != 0 or any(b < a for a, b in zip(off, off[1:]))
            or off[-1] > t):
        return [Violation("bad_offsets",
                          f"group offsets must be a non-decreasing prefix "
                          f"sum from 0 to at most T = {t}, got {off[:8]}")]
    g = len(off) - 1
    lg = grid or K.launch_grid(kernel, body, (g, t, K.STREAM_SLICE_STEP,
                                              1), tuple(tile),
                               kslices=kslices)
    axes = [np.arange(a) for a in lg.grid]
    x, y, z = (a.ravel() for a in np.meshgrid(*axes, indexing="ij"))
    grp, lo, hi, skip_lo, skip_hi = (
        np.broadcast_to(np.asarray(a, dtype=np.int64), x.shape)
        for a in lg.rows(x, y, z, np.asarray(off)))
    key, _ = (np.broadcast_to(np.asarray(a, dtype=np.int64), x.shape)
              for a in lg.arrival(x, y, z))
    v: list[Violation] = []
    # The CTAs of one counter sum K slices: the last stores, so each
    # counter's rows count once and must not depend on the slice.
    cta = np.stack([key, grp, lo, hi, skip_lo, skip_hi])
    rows = np.unique(cta, axis=1)
    if np.unique(rows[0]).size != rows.shape[1]:
        v.append(Violation("store_moves_with_reduction",
                           f"{kernel} {body}: a counter's K slices write "
                           "different rows"))
    _, grp, lo, hi, skip_lo, skip_hi = rows
    writes = np.zeros(t + 1, dtype=np.int64)
    np.add.at(writes, np.clip(lo, 0, t), 1)
    np.add.at(writes, np.clip(np.maximum(hi, lo), 0, t), -1)
    s0 = np.clip(np.maximum(skip_lo, lo), 0, t)
    s1 = np.clip(np.maximum(np.minimum(skip_hi, hi), s0), 0, t)
    np.add.at(writes, s0, -1)
    np.add.at(writes, s1, 1)
    count = np.cumsum(writes)[:t]
    if (count > 1).any():
        v.append(Violation(
            "write_race", f"{kernel} {body}: {int((count > 1).sum())} rows "
            f"have more than one writer, e.g. row {int(np.argmax(count > 1))}"
            f" (offsets {off[:8]})"))
    if (count < 1).any():
        v.append(Violation(
            "ragged_row_uncovered", f"{kernel} {body}: "
            f"{int((count < 1).sum())} rows are never written, e.g. row "
            f"{int(np.argmax(count < 1))} (offsets {off[:8]})"))
    own = np.asarray(off + [off[-1]], dtype=np.int64)
    is_group = (grp < g) & (hi > lo)
    gi = np.minimum(grp, g)
    stray = is_group & ((lo < own[gi]) | (hi > own[np.minimum(gi + 1, g)]))
    if stray.any():
        v.append(Violation(
            "ragged_extra_visit", f"{kernel} {body}: {int(stray.sum())} "
            "CTAs write rows their group does not own, e.g. group "
            f"{int(grp[np.argmax(stray)])} rows [{int(lo[np.argmax(stray)])},"
            f" {int(hi[np.argmax(stray)])}) (offsets {off[:8]})"))
    return v


# ---------------------------------------------------------------------------
# Contract 3: masking of the contraction remainder, on the CUDA sources
# ---------------------------------------------------------------------------

def _code(path: Path) -> str:
    """A source without its comments, whitespace collapsed."""
    text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return re.sub(r"\s+", " ", text)


def _calls(text: str, pattern: str) -> list[list[str]]:
    """The argument lists of every call whose head (up to and including its
    opening parenthesis) matches the regex ``pattern``."""
    out = []
    for m in re.finditer(pattern, text):
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        args, depth, cur = [], 0, ""
        for ch in text[m.end():i - 1]:
            if ch == "," and depth == 0:
                args.append(cur.strip())
                cur = ""
                continue
            depth += {"(": 1, ")": -1}.get(ch, 0)
            cur += ch
        args.append(cur.strip())
        out.append(args)
    return out


def masked_operands(csrc: str | Path | None = None
                    ) -> dict[tuple[str, str], tuple[int, int]]:
    """{(kernel, body): (operands whose K remainder is masked, operands of
    the contraction)} read from the CUDA sources in ``csrc`` (default the
    kernels' own): the FMA body's panel loads (``ftimm_common.cuh``:
    ``Panel::load`` zeroes k >= K, and ``accumulate`` loads A and each of
    its NB B panels with the K bound); the tensor cores' TMA boxes (TMA
    zero-fills past a tensor's extent on every operand it reads) and, for
    a window that ends inside the tensor, ``mask_tail`` (``zero_tail``
    zeroes the rows past the window in A's blocks and every B block), or
    split-K's windows of whole 64-row steps; the register stream's ``k <
    kl`` guards on the staged A rows and every B load; the group stream's
    TMA boxes over K slices of whole 64-row steps."""
    root = Path(csrc) if csrc is not None else K.CSRC
    common = _code(root / "ftimm_common.cuh")
    tc = _code(root / "ftimm_tc.cuh")
    gs = _code(root / "ftimm_gstream.cuh")
    panel = bool(re.search(r"gk < K \) \?|gk < K\) \?", common))

    def bounded(head: str) -> bool:
        calls = _calls(common, head)
        return bool(calls) and all(len(a) > 6 and a[6] == "K" for a in calls)

    fma_a = panel and bounded(r"\bpa\.load\(")
    fma_b = panel and bounded(r"\bpb\[nb\]\.load\(")
    tma_a = bool(re.search(r"tma_box\(sa[^;]*\bta\b", tc))
    tma_b = bool(re.search(r"tma_box\(sb[^;]*\btb\b", tc))
    tma_u = bool(re.search(r"tma_box\(sb[^;]*\btu\b", tc))
    tail = (bool(re.search(r"BLOCKS = 2 \+ T::BN / 64", tc))
            and bool(re.search(r"if \(mask_tail\) \{[^}]*zero_tail<T>", tc)))
    splitk_steps = all(_ref.k_per_split(k, 64, s) % 64 == 0
                       for k in (1, 63, 64, 65, 1000, 4097) for s in (1, 2, 3,
                                                                      8))
    gs_x = bool(re.search(r"tma_box\([^;]*&tx", gs))
    gs_w = bool(re.search(r"map = q == 0 \? &tw : &tu", gs))
    gs_win = (bool(re.search(r"k_hi = min\(p\.K, k_lo \+ p\.slice\)", gs))
              and bool(re.search(r"constexpr int BK = 64;", gs))
              and K.STREAM_SLICE_STEP % 64 == 0)
    out: dict[tuple[str, str], tuple[int, int]] = {}
    for kernel, bodies in K._BODY_KERNELS.items():
        text = _code(root / f"{kernel}.cu")
        pair = "swiglu" in kernel
        need = 3 if pair else 2
        if "fma" in bodies:
            calls = _calls(text, r"ftimm::accumulate<C, \d+>\(")
            nb = [int(n) for n in re.findall(r"ftimm::accumulate<C, (\d+)>\(",
                                              text)]
            got = (int(fma_a) + (nb[0] if fma_b else 0)) if nb else 0
            if kernel == "ftimm_gemm_ragged_dw" and not all(
                    len(a) > 9 and a[9] == "hi - lo" for a in calls):
                got = 0     # K must stop at the group's last row
            out[(kernel, "fma")] = (got, need)
        if "tc" in bodies:
            ok = True
            for args in _calls(text, r"run_tile<[^>]*>\("):
                k_lo, k_hi, mask = args[4], args[5], args[6]
                whole = k_lo == "0" and k_hi == "p.K"
                windowed = ((mask == "true" and tail) or
                            (kernel == "ftimm_gemm_splitk" and splitk_steps))
                ok = ok and (whole or windowed)
            got = (int(tma_a) + int(tma_b) + int(pair and tma_u)) if ok else 0
            out[(kernel, "tc")] = (got, need)
        if "stream" in bodies:
            if kernel in K._GROUP_STREAM:
                got = ((int(gs_x) + int(gs_w) * (2 if pair else 1))
                       if gs_win else 0)
            else:
                a = bool(re.search(r"kk < kl\) \? p\.a\[", text))
                loads = re.findall(r"= \(([^?;]*)\) \? load8\(", text)
                every = len(re.findall(r"(?<!uint4 )\bload8\(", text))
                b = (bool(loads) and len(loads) == every
                     and all(re.search(r"\bk < kl\b", c) for c in loads))
                got = int(a) + int(b)
            out[(kernel, "stream")] = (got, need)
    return out


def check_contraction_masking(csrc: str | Path | None = None
                              ) -> list[Violation]:
    """Contract 3 on the sources: every body of every kernel masks the K
    remainder of all its operands (``masked_operands``); the ragged dW's
    K is its group's rows, so an unmasked one is rows of the next group
    entering the panel (``missing_input_mask``)."""
    v = []
    for (kernel, body), (got, need) in masked_operands(csrc).items():
        if got < need:
            code = ("missing_input_mask" if kernel == "ftimm_gemm_ragged_dw"
                    else "missing_k_mask")
            v.append(Violation(code, f"{kernel} {body} body masks the K "
                                     f"remainder of {got} of its {need} "
                                     "operands (0 x NaN = NaN)"))
    return v


# ---------------------------------------------------------------------------
# Contract 5: placement
# ---------------------------------------------------------------------------

def _placement_rules(family: str, dims: Sequence[int], strategy: Any,
                     schedule: Any, nshards: int) -> list[Violation]:
    """The rules a placement and a sharded store record share."""
    if strategy not in STRATEGIES:
        return [Violation("bad_strategy", f"placement strategy {strategy!r} "
                                          f"not in {STRATEGIES}")]
    if nshards < 1:
        return [Violation("bad_shards", f"num_shards={nshards} must be >= 1")]
    if schedule not in SCHEDULES:
        return [Violation("bad_schedule", f"placement schedule {schedule!r} "
                                          f"not in {SCHEDULES}")]
    v: list[Violation] = []
    if schedule == "ring" and (family, strategy) not in _RING_LEGAL:
        v.append(Violation(
            "ring_undefined",
            f"ring schedule is undefined for ({family}, {strategy}); legal "
            f"pairs: {sorted(_RING_LEGAL)}"))
    if strategy == "expert_parallel":
        if family not in ("batched", "ragged"):
            v.append(Violation("strategy_family",
                               f"expert_parallel is undefined for {family}"))
        elif int(dims[0]) % nshards:
            v.append(Violation(
                "ep_indivisible",
                f"{int(dims[0])} experts over {nshards} shards leaves ragged "
                "expert placement; launch.sharding.expert_axis refuses this"))
    elif strategy == "k_parallel" and family != "dense":
        v.append(Violation("strategy_family",
                           f"k_parallel is undefined for {family}"))
    return v


def check_placement(family: str, dims: Sequence[int], placement: Any,
                    spec: Any = None) -> list[Violation]:
    """Placement contracts of one plan: a known strategy, shard count and
    schedule; the ring only where a chunk rotation is defined; EP only for
    the grouped and ragged families, with the group count divisible by the
    shard count; k_parallel only for dense, warned when a shard's K slice
    is shorter than one tensor-core K step (``kernel.TC_TILES``)."""
    nshards = int(getattr(placement, "num_shards", 1))
    strategy = getattr(placement, "strategy", None)
    v = _placement_rules(family, dims, strategy,
                         getattr(placement, "schedule", "gather"), nshards)
    if (strategy == "k_parallel" and family == "dense" and not errors(v)
            and nshards > 1):
        step = min(t[2] for t in K.TC_TILES)
        k = int(dims[1])
        if nshards > _cdiv(max(k, 1), step):
            v.append(Violation(
                "kparallel_overshard",
                f"{nshards} K-shards over K={k} leave shards without a full "
                f"{step}-wide tensor-core K step", severity="warning"))
    return v


# ---------------------------------------------------------------------------
# The umbrella check
# ---------------------------------------------------------------------------

def check_plan(family: str, dims: Sequence[int], plan: Any, *,
               in_bytes: int = 4, out_bytes: int = 4, spec: Any = None,
               epilogue: Any = None, swiglu: bool = False, ragged: str = "m",
               coverage: bool = False,
               b_bytes: int | None = None) -> list[Violation]:
    """Check one plan (a ``tuner.GemmPlan`` or anything duck-typed like one)
    against the static contracts; ``coverage=True`` also enumerates its
    launch's stores (all families but the ragged forward, whose rows
    ``check_ragged_rows`` proves)."""
    nsplit = int(getattr(plan, "nsplit", 1))
    body = getattr(plan, "body", "fma")
    panels = 2 if swiglu else 1
    tile = dict(bm=int(plan.bm), bn=int(plan.bn), bk=int(plan.bk))
    v = check_blocks(family, dims, nsplit=nsplit,
                     dim_order=getattr(plan, "dim_order", "mn"),
                     edge=getattr(plan, "edge", "masked"), in_bytes=in_bytes,
                     out_bytes=out_bytes, ragged=ragged, body=body,
                     kslices=int(getattr(plan, "kslices", 1)),
                     panels=panels, b_bytes=b_bytes, **tile)
    codes = {x.code for x in v}
    if not codes & {"unknown_body", "bad_family", "bad_dims",
                    "nonpositive_block"}:
        v += check_budget(plan_kernel(family, panels=panels, nsplit=nsplit,
                                      ragged=ragged), body, panels=panels,
                          spec=spec, **tile)
    v += check_schedule(nsplit=nsplit, fuse=getattr(plan, "fuse", True),
                        epilogue=epilogue, swiglu=swiglu)
    placement = getattr(plan, "placement", None)
    if placement is not None and int(getattr(placement, "num_shards", 1)) > 1:
        v += check_placement(family, dims, placement, spec=spec)
    if (coverage and not errors(v)
            and not (family == "ragged" and ragged == "m")):
        v += verify_contract(variant_contract(family, dims, plan,
                                              swiglu=swiglu, ragged=ragged))
    return v


def assert_plan(family: str, dims: Sequence[int], plan: Any,
                **kwargs: Any) -> None:
    """Raise ``ContractError`` when any error-severity contract is violated:
    the ``REPRO_VERIFY=1`` dispatch hook."""
    bad = errors(check_plan(family, dims, plan, **kwargs))
    if bad:
        raise ContractError(bad, context=f"{family}{tuple(dims)}")


# ---------------------------------------------------------------------------
# Stored records (the plan store's load-time quarantine)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RecordKey:
    """A parsed ``plan_store.shape_key``."""
    family: str
    dims: tuple[int, ...]
    in_bytes: int
    out_bytes: int
    num_shards: int = 1
    extra: str = ""


def parse_key(key: str) -> RecordKey | None:
    """Parse ``family|MxKxN|ib4|ob4[|extra][|shardsN]`` (the plan store's
    key grammar); None when malformed."""
    parts = key.split("|")
    if len(parts) < 4:
        return None
    try:
        dims = tuple(int(x) for x in parts[1].split("x"))
        if not (parts[2].startswith("ib") and parts[3].startswith("ob")):
            return None
        in_bytes, out_bytes = int(parts[2][2:]), int(parts[3][2:])
    except ValueError:
        return None
    num_shards, extra = 1, ""
    for p in parts[4:]:
        if p.startswith("shards"):
            try:
                num_shards = int(p[6:])
            except ValueError:
                return None
        else:
            extra = p
    return RecordKey(parts[0], dims, in_bytes, out_bytes, num_shards, extra)


def check_record(key: str, rec: Any, spec: Any = None) -> list[Violation]:
    """Validate one stored record against the static contracts: the load-time
    quarantine.  A key of no family the port plans, or with the wrong
    number of dims, is ``malformed_key``; a record that is not a mapping or
    lacks a tile, ``malformed_record``; a mixed or 1-byte record with a
    split count, ``splitk_mixed_dtype`` (no split-K kernel takes such a
    pair, so no such record is ever measured); the rest are the plan
    contracts at the key's shape, widths and variant (``ragged:k`` the dW,
    ``pair`` a SwiGLU pair, ``bb{n}`` B's width).  A ``|shardsN`` key's
    record is a placed one: its ``strategy`` and ``schedule`` are held to
    the placement rules (``bad_strategy``, ``bad_schedule``,
    ``ring_undefined``, ``ep_indivisible``, ``strategy_family``) and its
    tile to the tiles the body is compiled for (``tile_not_compiled``,
    ``nonpositive_block``); the local shape it was measured at is the
    placement option's, so no shape contract applies."""
    pk = parse_key(key)
    if (pk is None or pk.family not in FAMILIES
            or len(pk.dims) != _NDIMS[pk.family]):
        return [Violation("malformed_key", f"unparseable plan-store key "
                                           f"{key!r}")]
    if not isinstance(rec, dict):
        return [Violation("malformed_record", "record is not a mapping")]
    try:
        bm, bn, bk = int(rec["bm"]), int(rec["bn"]), int(rec["bk"])
        body = str(rec.get("body", "fma"))
        nsplit = int(rec.get("nsplit", 1))
        kslices = int(rec.get("kslices", 1))
        dim_order = str(rec.get("dim_order", "mn"))
        edge = str(rec.get("edge", "masked"))
        fuse = bool(rec.get("fuse", True))
    except (KeyError, TypeError, ValueError):
        return [Violation("malformed_record",
                          f"record for {key!r} is missing or mistyping its "
                          "tile fields")]
    ragged, b_bytes, panels = "m", None, 1
    for part in pk.extra.split("+"):
        if part.startswith("ragged:"):
            ragged = part[len("ragged:"):]
        elif part == "pair":
            panels = 2
        elif part.startswith("bb"):
            try:
                b_bytes = int(part[2:])
            except ValueError:
                return [Violation("malformed_key", f"unparseable width "
                                                   f"{part!r} in {key!r}")]
    if ragged not in ("m", "k"):
        return [Violation("malformed_key", f"ragged axis {ragged!r} in "
                                           f"{key!r}")]
    widths = (pk.in_bytes, b_bytes or pk.in_bytes)
    if nsplit > 1 and (widths[0] != widths[1] or 1 in widths):
        return [Violation(
            "splitk_mixed_dtype",
            f"record for widths {widths} claims nsplit={nsplit}; no split-K "
            "kernel takes a mixed or 1-byte pair")]
    if pk.num_shards > 1:
        v = _placement_rules(pk.family, pk.dims, rec.get("strategy"),
                             rec.get("schedule", "gather"), pk.num_shards)
        if errors(v):
            return v
        if min(bm, bn, bk) <= 0 or nsplit <= 0:
            return v + [Violation("nonpositive_block",
                                  f"bm={bm} bn={bn} bk={bk} nsplit={nsplit}")]
        kernel = plan_kernel(pk.family, panels=panels, nsplit=nsplit,
                             ragged=ragged)
        if not _tile_compiled(kernel, body, bm, bn, bk, widths):
            v.append(Violation("tile_not_compiled",
                               f"({bm}, {bn}, {bk}) is not a tile "
                               f"{kernel}'s {body} body is compiled for"))
        return v
    return check_plan(
        pk.family, pk.dims,
        _Record(bm, bn, bk, nsplit, dim_order, edge, body, kslices, fuse),
        in_bytes=pk.in_bytes, out_bytes=pk.out_bytes, spec=spec,
        swiglu=panels == 2, ragged=ragged, b_bytes=b_bytes)


@dataclass(frozen=True)
class _Record:
    """A stored record's decision, shaped like a plan for ``check_plan``."""
    bm: int
    bn: int
    bk: int
    nsplit: int
    dim_order: str
    edge: str
    body: str
    kslices: int
    fuse: bool
