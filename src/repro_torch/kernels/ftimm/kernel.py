"""ftIMM GEMM kernels for Hopper, with their plain PyTorch versions.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/``, one source per kernel:

  * ``ftimm_gemm``          dense C = epi(op(A) . op(B)), trans nn / tn / nt;
  * ``ftimm_gemm_swiglu``   silu(x . Wg) * (x . Wu) in one launch;
  * ``ftimm_gemm_grouped``  one GEMM per group, either operand may be shared;
  * ``ftimm_gemm_grouped_swiglu``  the SwiGLU pair per group (capacity MoE);
  * ``ftimm_gemm_ragged``   per-group row chunks of one flat operand against
                            per-group panels (capacity-free MoE);
  * ``ftimm_gemm_ragged_swiglu``  the ragged SwiGLU pair;
  * ``ftimm_gemm_ragged_dw``  per-group x^T . dy over each group's rows, the
                            weight gradient of the ragged experts;
  * ``ftimm_gemm_splitk``   dense products over K slices, the fp32 partials
                            summed in split order, then the epilogue.

``ftimm_gemm``, ``ftimm_gemm_grouped``, ``ftimm_gemm_ragged`` and the
three SwiGLU pairs have three bodies, ``ftimm_gemm_grouped`` a fourth, and
``ftimm_gemm_ragged_dw`` and ``ftimm_gemm_splitk`` the first two:
CUDA-core FMAs on any operand types
and strides (``"fma"``; the only body that takes the quantized pairs of
``ftimm_gemm`` and ``ftimm_gemm_ragged``: bf16 / fp32 x int8, int8 x int8
summed in int32, fp8 x fp8, and the dense kernel's bf16 / fp32 x fp8
straight-through dX), tensor cores for bf16 x bf16 operands TMA can
read (``"tc"``: TMA, an mbarrier ring and wgmma, ``csrc/ftimm_tc.cuh``;
the grouped and ragged kernels read their panels through 3-D tensor maps,
the pairs both panels into one stage, split-K sums its partials in split
order inside the kernel), and a K-parallel weight stream for bf16 x bf16
calls of at most 16 rows (``"stream"``: ``ftimm_gemm``'s register stream,
and for the grouped and ragged kernels and the three pairs a TMA ring per
(N strip, K slice, group) feeding wgmma with the weight as the 64-row
operand, ``csrc/ftimm_gstream.cuh``; the dense pair is its one group);
the grouped kernel's few-rows fp32 stream takes fp32 x fp32 calls of at
most ROWS_MAX rows a group with B's rows unit-stride and 16-byte aligned
(``"rows"``: the decode attention products, B's rows through a per-warp
cp.async ring, A on chip, ``csrc/ftimm_rows.cuh``).
The planner picks the body (``core.gemm.tuner``) among those
``gemm_bodies`` /
``grouped_bodies`` / ``ragged_bodies`` / ``ragged_dw_bodies`` allow for
the call's types and operand layouts, a rule decided before the launch;
the wrapper raises on a body the operands do not allow.  ``body_counts``
shows which body carried a run.

Each is compiled by ``nvcc`` at first use into a shared library with a plain
C interface under the git-ignored ``build/ftimm/`` directory of the checkout
(one ``nvcc`` per source, all started together; a library is named by the
hash of the sources and flags, so an edit never reuses a stale build) and
bound with ``ctypes``.

Every wrapper decides its engine by the device of the tensor it is given: a
CPU tensor takes the plain version (the ``*_plain`` functions here, built on
``ref``), a CUDA tensor launches the kernel or raises -- there is no path on
which a CUDA tensor quietly takes the plain version.  Each successful launch
adds one to that kernel's count (``launch_counts``), and nothing else does.

A ``meta`` tensor (the production-mesh dry run, ``launch.dryrun``: shapes,
no storage) takes the plain version too, which on ``meta`` computes no
value and moves no byte, rather than a shape function for each of the
eight entries: the plain version's output shape and dtype are the
kernel's by construction (the tests hold them to each other), so no
second statement of them can drift, and its products are ``torch``
operations that ``FlopCounterMode`` counts.  What that costs: the
operands' fp32 copies and the ragged products' group-by-group masked
passes of the plain versions show in the dry run's tracked temporaries
and FLOP count, which therefore exceed the kernels' (``launch.dryrun``).
No plain version reads a value to the host (the ragged ones read their
offsets on the device), so none needs a bound on ``meta``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import ref
from .epilogue import IDENTITY, Epilogue

KERNELS = ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped",
           "ftimm_gemm_grouped_swiglu", "ftimm_gemm_ragged",
           "ftimm_gemm_ragged_swiglu", "ftimm_gemm_ragged_dw",
           "ftimm_gemm_splitk")
CSRC = Path(__file__).with_name("csrc")
# The devices whose tensors take the plain versions (no kernel launch).
PLAIN_DEVICES = ("cpu", "meta")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "ftimm"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The compiled tile menu (bm, bn, bk) of the FMA body, in the order of
# Tile0..Tile3 in csrc/ftimm_common.cuh.  The planner chooses among exactly
# these.
TILES = ((16, 32, 64), (32, 64, 32), (64, 64, 32), (128, 128, 16))
# The tensor-core body's tiles (FTIMM_TC_TILES / FTIMM_DW_TC_TILES in
# csrc), and each kernel's ring depth: the dense GEMM walks long K, a ragged
# dW group's rows are one or two 64-row steps.
TC_TILES = ((128, 128, 64), (128, 256, 64))
TC_STAGES = {"ftimm_gemm": 4, "ftimm_gemm_ragged_dw": 2,
             "ftimm_gemm_grouped": 4, "ftimm_gemm_ragged": 4,
             "ftimm_gemm_splitk": 4, "ftimm_gemm_swiglu": 4,
             "ftimm_gemm_grouped_swiglu": 4, "ftimm_gemm_ragged_swiglu": 4}
# The grouped and ragged kernels' one tensor-core tile (GroupedTcTile /
# RaggedTcTile in csrc).
GROUP_TC_TILE = TC_TILES[0]
# The weight-stream body: the compiled row counts (a call of M <= 16 rows
# runs the smallest that holds M), the output columns of one CTA, the K
# granularity of a slice, and the shared memory a slice's staged rows may
# take.
STREAM_ROWS = (4, 8, 16)
STREAM_STRIP = 128
STREAM_SLICE_STEP = 64
STREAM_SMEM = 24 * 1024
# The grouped and ragged weight stream (csrc/ftimm_gstream.cuh): at most
# GSTREAM_ROWS rows a group (the ragged kernel: in all), 64-row K boxes of
# a 128-column strip through a GSTREAM_STAGES-deep ring.
GSTREAM_ROWS = 16
GSTREAM_STAGES = 4
# The grouped kernel's few-rows fp32 stream (csrc/ftimm_rows.cuh): at most
# ROWS_MAX rows a group; a row of B is read in float4 slices by 16 or 32
# lanes, one or two slices a lane, so a CTA covers ROWS_WIDTHS floats of it
# ("nt": K per slice; "nn": output columns per CTA); "nn" stages A over a K
# slice of at most ROWS_SPAN_MAX cache rows in shared memory beside the
# ROWS_RING_BYTES ring.  ``rows_tile`` cuts a call as the H100 sweep of
# its cuts (``launch.sweep_gemm --set attention``, PERF.md) ran fastest:
# "nt" into at least ROWS_CTAS CTAs (two an SM) of ROWS_MIN_STRIP or more
# cache rows, and of at most ROWS_STRIP_BYTES of them; "nn" into the
# narrowest column strips (64 floats: more CTAs, no reduction, never
# slower than the wider strips), and into K slices only when one (group,
# strip) reads more than ROWS_SLICE_MIN_BYTES -- the slices' ordered
# reduction costs about 1.5 us -- then into slices of about
# ROWS_SLICE_BYTES, at most ROWS_SLICES_MAX.
ROWS_MAX = 8
ROWS_WIDTHS = (64, 128, 256)
ROWS_SPAN_MAX = 2048
ROWS_RING_BYTES = 8 * 4 * 128 * 16
ROWS_CTAS = 264
ROWS_MIN_STRIP = 16
ROWS_STRIP_BYTES = 16 * 1024
ROWS_SLICE_MIN_BYTES = 160 * 1024
ROWS_SLICE_BYTES = 64 * 1024
ROWS_SLICES_MAX = 8
BODIES = ("fma", "tc", "stream")
_BODY_KERNELS = {"ftimm_gemm": BODIES, "ftimm_gemm_swiglu": BODIES,
                 "ftimm_gemm_grouped": BODIES + ("rows",),
                 "ftimm_gemm_grouped_swiglu": BODIES,
                 "ftimm_gemm_ragged": BODIES,
                 "ftimm_gemm_ragged_swiglu": BODIES,
                 "ftimm_gemm_ragged_dw": ("fma", "tc"),
                 "ftimm_gemm_splitk": ("fma", "tc")}

# (A dtype, B dtype, output dtype) -> the type code of the C entries
# (FTIMM_TYPES / FTIMM_MIXED_TYPES / FTIMM_QUANT_TYPES /
# FTIMM_QUANT_DX_TYPES in csrc/ftimm_common.cuh).  The mixed bf16 x fp32
# pairs are built for the kernels in _MIXED, whose operands are
# independent: the backward meets them where an fp32 cotangent (the logits',
# the router's) multiplies bf16 weights or activations.  The quantized
# codes (7-16: weight-only bf16 / fp32 x int8, int8 x int8 with an int32
# accumulator, fp8 x fp8) are built for the FMA bodies of the kernels in
# _QUANT, the straight-through dX codes (17-20: a bf16 / fp32 cotangent x
# an fp8 panel, to fp32) for ``ftimm_gemm`` only.
_BF16, _F32, _I8 = torch.bfloat16, torch.float32, torch.int8
_E4M3, _E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_TYPE_CODES = {
    (_BF16, _BF16, _BF16): 0, (_BF16, _BF16, _F32): 1, (_F32, _F32, _F32): 2,
    (_BF16, _F32, _BF16): 3, (_BF16, _F32, _F32): 4,
    (_F32, _BF16, _BF16): 5, (_F32, _BF16, _F32): 6,
    (_BF16, _I8, _BF16): 7, (_BF16, _I8, _F32): 8,
    (_F32, _I8, _BF16): 9, (_F32, _I8, _F32): 10,
    (_I8, _I8, _BF16): 11, (_I8, _I8, _F32): 12,
    (_E4M3, _E4M3, _BF16): 13, (_E4M3, _E4M3, _F32): 14,
    (_E5M2, _E5M2, _BF16): 15, (_E5M2, _E5M2, _F32): 16,
    (_BF16, _E4M3, _F32): 17, (_F32, _E4M3, _F32): 18,
    (_BF16, _E5M2, _F32): 19, (_F32, _E5M2, _F32): 20,
}
_MIXED = frozenset({"ftimm_gemm", "ftimm_gemm_grouped", "ftimm_gemm_ragged",
                    "ftimm_gemm_ragged_dw", "ftimm_gemm_splitk"})
_QUANT = {"ftimm_gemm": range(7, 21), "ftimm_gemm_ragged": range(7, 17)}
# The FMA tiles the quantized codes are compiled for (FTIMM_QUANT_TILES):
# the decode tile and the 64 x 64 one; the planner gives a call with a
# 1-byte operand no other (``fma_tiles``).
QUANT_TILES = (TILES[0], TILES[2])
_ACT_CODES = {"none": 0, "silu": 1, "gelu": 2}

_launches = dict.fromkeys(KERNELS, 0)
_body_launches = {(k, b): 0 for k, bodies in _BODY_KERNELS.items()
                  for b in bodies}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(_launches)


def body_counts() -> dict[str, dict[str, int]]:
    """{kernel: {body: launches}} since the last ``reset_launch_counts``,
    for the kernels with more than one body; each kernel's bodies sum to its
    ``launch_counts`` entry."""
    out: dict[str, dict[str, int]] = {}
    for (kernel, body), n in _body_launches.items():
        out.setdefault(kernel, {})[body] = n
    return out


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    for key in _body_launches:
        _body_launches[key] = 0


def smem_bytes(bm: int, bn: int, bk: int, panels: int = 1, *,
               body: str = "fma", stages: int = 4) -> int:
    """Shared memory of one CTA.  FMA body: the static fp32 [bk][bm+1] A
    panel plus ``panels`` [bk][bn+1] B panels (2 for the fused SwiGLU pair).
    Tensor cores: the ``stages``-deep bf16 ring of (bm x bk) and
    ``panels`` (bn x bk) boxes (the pair: a 128 x 256 stage), or the
    flush's fp32 staging tile (bm, panels x bn + 8) if larger, the ring's
    barriers and 1 KB to align it (csrc/ftimm_tc.cuh, Tile::SMEM).
    Stream (bm = the compiled row count, bk = the slice): the staged bf16
    rows, the reduction's fp32 (8 warps x bn) and (bm x bn) tiles.  Rows
    (``rows_tile``'s (ROWS_MAX, N per CTA, K per slice)): the ring and,
    at most, "nn"'s fp32 A over a K slice (bm x bk)."""
    if body == "fma":
        return 4 * (bk * (bm + 1) + panels * bk * (bn + 1))
    if body == "tc":
        ring = stages * (bm * bk + panels * bn * bk) * 2
        return max(ring, bm * (panels * bn + 8) * 4) + 16 * stages + 1024
    if body == "stream":
        return bm * (bk + 7) // 8 * 8 * 2 + 4 * (8 * bn + bm * bn) + 4
    if body == "rows":
        return ROWS_RING_BYTES + 4 * bm * bk + 4
    raise ValueError(f"unknown body: {body!r}")


def gstream_smem(panels: int = 1) -> int:
    """Shared memory of one CTA of the grouped / ragged weight stream: the
    GSTREAM_STAGES-deep ring of ``panels`` (64 K x 128 N) weight boxes (2:
    the SwiGLU pair's Wg and Wu) and a (64 K x 16 rows) activation box a
    stage, an fp32 (16, 128 + 4) staging tile per panel, the barriers and
    1 KB to align the ring (csrc/ftimm_gstream.cuh, Ring::SMEM)."""
    stage = panels * STREAM_STRIP * 64 * 2 + GSTREAM_ROWS * 64 * 2
    return GSTREAM_STAGES * stage \
        + panels * GSTREAM_ROWS * (STREAM_STRIP + 4) * 4 \
        + 16 * GSTREAM_STAGES + 1024


def tma_major(ptr: int, rows: int, k: int, s_rows: int,
              s_k: int) -> str | None:
    """How the tensor-core body reads one operand op(X)(r, k) = X[r * s_rows
    + k * s_k] of ``rows`` x ``k`` elements: "k" (K has unit stride),
    "mn" (the rows do), or None when TMA cannot read it -- no unit-stride
    dimension, a base not 16-byte aligned, or the other stride not a
    multiple of 16 bytes or shorter than the unit-stride extent (an extent
    of 1 takes any stride).  The operands are bf16: 16 bytes are 8
    elements.  The C entries (csrc/ftimm_tc.cuh, encode_operand) apply the
    same rule."""
    if rows < 1 or k < 1 or ptr % 16:
        return None
    if s_k == 1:
        major, other, stride, inner = "k", rows, s_rows, k
    elif s_rows == 1:
        major, other, stride, inner = "mn", k, s_k, rows
    else:
        return None
    if other == 1:
        return major
    return major if stride % 8 == 0 and stride >= inner else None


def tma_major3(ptr: int, g: int, rows: int, k: int, s_g: int, s_rows: int,
               s_k: int) -> str | None:
    """``tma_major`` for a grouped operand of ``g`` panels ``s_g`` elements
    apart: a 2-D map when the panel is shared (``s_g`` 0) or alone, else a
    rank-3 map, which TMA takes when ``s_g`` is a multiple of 8 elements and
    at least one panel (csrc/ftimm_tc.cuh, encode_operand)."""
    major = tma_major(ptr, rows, k, s_rows, s_k)
    if major is None or g <= 1 or s_g == 0:
        return major
    if major == "k":
        outer, extent = (s_rows if rows > 1 else -(-k // 8) * 8), rows
    else:
        outer, extent = (s_k if k > 1 else -(-rows // 8) * 8), k
    return major if s_g % 8 == 0 and s_g >= outer * extent else None


def op_strides(trans: str, a: torch.Tensor,
               b: torch.Tensor) -> tuple[int, int, int, int]:
    """(sam, sak, sbk, sbn): element strides of op(A) (M, K) and op(B)
    (K, N) for ``trans``."""
    sam, sak = ((a.stride(1), a.stride(0)) if trans == "tn"
                else (a.stride(0), a.stride(1)))
    sbk, sbn = ((b.stride(1), b.stride(0)) if trans == "nt"
                else (b.stride(0), b.stride(1)))
    return sam, sak, sbk, sbn


def gemm_operands_ok(a: torch.Tensor, b: torch.Tensor,
                     trans: str) -> tuple[bool, bool]:
    """Whether TMA (and the stream body's 16-byte loads) can read op(A) and
    op(B) of a dense call, as laid out."""
    m, k, n = mkn(trans, a.shape, b.shape)
    sam, sak, sbk, sbn = op_strides(trans, a, b)
    return (tma_major(a.data_ptr(), m, k, sam, sak) is not None,
            tma_major(b.data_ptr(), n, k, sbn, sbk) is not None)


def gemm_bodies(a_bytes: int, b_bytes: int, m: int, a_ok: bool, b_ok: bool,
                panels: int = 1) -> tuple[str, ...]:
    """The bodies of ``ftimm_gemm`` (and of ``ftimm_gemm_splitk``, which
    takes its "fma" and "tc") that can take a call, for the planner to
    choose among: the FMA body takes every type pair and layout (a pair
    with a 1-byte operand, int8 or fp8, takes only it); the tensor-core
    body bf16 x bf16 when TMA can read both operands; the stream body
    bf16 x bf16 of at most 16 rows when its 16-byte loads can read B (A is
    staged element by element).  The dense SwiGLU pair (``panels`` = 2,
    ``ftimm_gemm_swiglu``; ``a_ok``: TMA reads x K-major, ``b_ok``: it
    reads both panels, ``swiglu_operands``) takes the grouped pair's rule
    with one group: for bf16 x bf16 the tensor cores, and the group stream
    at most GSTREAM_ROWS rows."""
    bodies = ["fma"]
    if a_bytes != 2 or b_bytes != 2:
        return tuple(bodies)
    if panels == 2:
        return grouped_bodies(a_bytes, b_bytes, m, "k" if a_ok else None,
                              b_ok)
    if a_ok and b_ok:
        bodies.append("tc")
    if m <= STREAM_ROWS[-1] and b_ok:
        bodies.append("stream")
    return tuple(bodies)


def swiglu_operands(x: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor) -> tuple[bool, bool]:
    """Whether TMA reads x (M, K) K-major, and both panels (K, N) as laid
    out (in one layout), for the dense pair's ``gemm_bodies`` rule."""
    m, k = x.shape
    n = w_gate.shape[1]
    majors = {tma_major(w.data_ptr(), n, k, w.stride(1), w.stride(0))
              for w in (w_gate, w_up)}
    return (tma_major(x.data_ptr(), m, k, x.stride(0), x.stride(1)) == "k",
            None not in majors and len(majors) == 1)


def _group_strides(t: torch.Tensor, rows_first: bool) -> tuple[int, int, int]:
    """(group, row, k) element strides of op(X) for a 3-D operand, or a
    2-D one shared by every group (group stride 0)."""
    gs = t.stride(0) if t.ndim == 3 else 0
    s0, s1 = t.stride(-2), t.stride(-1)
    return (gs, s0, s1) if rows_first else (gs, s1, s0)


def grouped_operands(a: torch.Tensor, b: torch.Tensor,
                     trans: str) -> tuple[str | None, bool]:
    """How TMA reads op(A) of a grouped call ("k", "mn" or None) and
    whether it can read op(B), as laid out."""
    m, k, n = mkn(trans, a.shape[-2:], b.shape[-2:])
    g = a.shape[0] if a.ndim == 3 else b.shape[0]
    sag, sam, sak = _group_strides(a, trans != "tn")
    sbg, sbk, sbn = _group_strides(b, trans != "nt")
    return (tma_major3(a.data_ptr(), g, m, k, sag, sam, sak),
            tma_major3(b.data_ptr(), g, n, k, sbg, sbn, sbk) is not None)


def grouped_bodies(a_bytes: int, b_bytes: int, m: int, a_major: str | None,
                   b_ok: bool, *, trans: str | None = None,
                   b_rows: bool = False) -> tuple[str, ...]:
    """The bodies of ``ftimm_gemm_grouped`` and of its SwiGLU pair
    (``ftimm_gemm_grouped_swiglu``, whose op(B) is each of its two panels)
    that can take a call: FMA always; for bf16 x bf16 with op(B)
    TMA-readable the tensor cores when TMA reads op(A) too (``a_major`` not
    None), and the weight stream when a group has at most GSTREAM_ROWS rows
    and op(A) is K-major; for fp32 x fp32 of at most ROWS_MAX rows a group,
    ``trans`` "nn" or "nt" and B's rows as the rows body reads them
    (``b_rows``: ``rows_operand``) the few-rows stream -- the grouped
    kernel's only (the pair passes no ``trans``).  The mixed pairs, and fp32
    of more rows, stay FMA."""
    bodies = ["fma"]
    if a_bytes == b_bytes == 2 and b_ok and a_major:
        bodies.append("tc")
        if m <= GSTREAM_ROWS and a_major == "k":
            bodies.append("stream")
    if (a_bytes == b_bytes == 4 and m <= ROWS_MAX and trans in ("nn", "nt")
            and b_rows):
        bodies.append("rows")
    return tuple(bodies)


def rows_operand(b: torch.Tensor) -> bool:
    """Whether the rows body reads op(B) of a grouped "nn" or "nt" call as
    laid out: its rows (the last dimension: head_dim of a cache row) unit
    stride, the base 16-byte aligned, the row and group strides multiples
    of 4 elements (16 bytes of fp32).  An extent of 1 takes any stride.
    The C entry (csrc/ftimm_rows.cuh, rows::launch) applies the same rule."""
    unit = b.shape[-1] <= 1 or b.stride(-1) == 1
    rows = b.shape[-2] <= 1 or b.stride(-2) % 4 == 0
    groups = b.ndim == 2 or b.shape[0] <= 1 or b.stride(0) % 4 == 0
    return unit and rows and groups and b.data_ptr() % 16 == 0


def rows_width(length: int) -> int:
    """Floats of a B row one rows CTA covers (a width of ROWS_WIDTHS): 16
    lanes a row for rows of at most 64 floats, else 32, and two float4s a
    lane past 128."""
    for width in ROWS_WIDTHS:
        if length <= width:
            return width
    return ROWS_WIDTHS[-1]


def rows_tile(g: int, k: int, n: int, trans: str) -> tuple[int, int, int]:
    """The rows body's cut of a grouped call, as (ROWS_MAX, N per CTA, K per
    slice), the plan's tile.  "nt" (K = head_dim): strips of cache rows --
    enough for ROWS_CTAS CTAs, none under ROWS_MIN_STRIP rows nor over
    ROWS_STRIP_BYTES -- and K slices of ``rows_width(k)``.  "nn" (K = the
    cache rows): strips of the narrowest width, and K slices of cache rows
    only past ROWS_SLICE_MIN_BYTES of a strip's rows: about
    ROWS_SLICE_BYTES each, at most ROWS_SLICES_MAX and ROWS_SPAN_MAX
    rows."""
    if trans == "nt":
        width = rows_width(k)
        slices = max(_cdiv(k, width), 1)
        strip = max(_cdiv(n, _cdiv(ROWS_CTAS, g * slices)), ROWS_MIN_STRIP)
        cap = max(ROWS_STRIP_BYTES // (4 * max(min(k, width), 1)),
                  ROWS_MIN_STRIP)
        return ROWS_MAX, min(strip, cap), width
    width = ROWS_WIDTHS[0]
    nbytes = 4 * k * min(n, width)
    slices = (1 if nbytes <= ROWS_SLICE_MIN_BYTES
              else min(_cdiv(nbytes, ROWS_SLICE_BYTES), ROWS_SLICES_MAX))
    span = max(_cdiv(max(k, 1), slices), _cdiv(k, ROWS_SPAN_MAX))
    return ROWS_MAX, width, min(span, ROWS_SPAN_MAX)


def rows_tile_ok(bm: int, bn: int, bk: int, trans: str) -> bool:
    """Whether the rows body takes the cut (``bm``, ``bn``, ``bk``) for
    ``trans``: ROWS_MAX rows, a row width of ROWS_WIDTHS ("nt": ``bk``;
    "nn": ``bn``) and a span of at least one ("nt": ``bn`` cache rows;
    "nn": ``bk``, at most ROWS_SPAN_MAX)."""
    if trans not in ("nn", "nt"):
        return False
    nt = trans == "nt"
    width, span = (bk, bn) if nt else (bn, bk)
    return (bm == ROWS_MAX and width in ROWS_WIDTHS and span >= 1
            and (nt or span <= ROWS_SPAN_MAX))


def ragged_operands(x: torch.Tensor, w: torch.Tensor,
                    trans: str) -> tuple[bool, bool]:
    """Whether TMA reads x (T, K) K-major and the panels op(W_g) as laid
    out (``trans`` "nn": W (G, K, N); "nt": W (G, N, K))."""
    (t, k), g = x.shape, w.shape[0]
    n = w.shape[2] if trans == "nn" else w.shape[1]
    swk, swn = ((w.stride(1), w.stride(2)) if trans == "nn"
                else (w.stride(2), w.stride(1)))
    return (tma_major(x.data_ptr(), t, k, x.stride(0), x.stride(1)) == "k",
            tma_major3(w.data_ptr(), g, n, k, w.stride(0), swn, swk)
            is not None)


def ragged_bodies(x_bytes: int, w_bytes: int, total: int, x_k: bool,
                  w_ok: bool) -> tuple[str, ...]:
    """The bodies of ``ftimm_gemm_ragged`` and of its SwiGLU pair
    (``ftimm_gemm_ragged_swiglu``) that can take a call: FMA always; for
    bf16 x bf16 with x K-major and the panels TMA-readable the tensor
    cores, and the weight stream when all ``total`` rows are at most
    GSTREAM_ROWS (then no group holds more; the per-group counts stay on
    the device)."""
    bodies = ["fma"]
    if x_bytes == w_bytes == 2 and x_k and w_ok:
        bodies.append("tc")
        if total <= GSTREAM_ROWS:
            bodies.append("stream")
    return tuple(bodies)


def ragged_dw_bodies(x_bytes: int, dy_bytes: int, x_mn: bool,
                     dy_mn: bool) -> tuple[str, ...]:
    """The bodies of ``ftimm_gemm_ragged_dw`` that can take a call: FMA
    always; tensor cores for bf16 x bf16 when TMA reads x^T and dy
    MN-major (both row-major, D and F unit-stride), the layout whose
    group row tail the kernel masks."""
    if x_bytes == dy_bytes == 2 and x_mn and dy_mn:
        return ("fma", "tc")
    return ("fma",)


def ragged_dw_operands_mn(x: torch.Tensor, dy: torch.Tensor) -> tuple[bool, bool]:
    """Whether TMA reads x^T (D x T) and dy (T x F) MN-major."""
    (t, d), f = x.shape, dy.shape[1]
    return (tma_major(x.data_ptr(), d, t, x.stride(1), x.stride(0)) == "mn",
            tma_major(dy.data_ptr(), f, t, dy.stride(1), dy.stride(0)) == "mn")


def stream_rows(m: int) -> int:
    """The compiled row count of the stream body that holds ``m`` rows."""
    for rows in STREAM_ROWS:
        if m <= rows:
            return rows
    raise ValueError(f"the stream body takes at most {STREAM_ROWS[-1]} rows, "
                     f"got {m}")


def stream_slice(k: int, kslices: int) -> tuple[int, int]:
    """(slice, slices): K cut into ``kslices`` slices of a whole number of
    STREAM_SLICE_STEP rows; the count that results (the last slice may be
    short, none is empty)."""
    step = STREAM_SLICE_STEP
    sl = max(-(-max(k, 1) // max(kslices, 1)) + step - 1, step) // step * step
    return sl, -(-max(k, 1) // sl)


def fma_tiles(a_bytes: int, b_bytes: int) -> tuple:
    """The FMA body's compiled tiles for an operand pair: QUANT_TILES when
    either operand is 1 byte, else TILES."""
    return QUANT_TILES if 1 in (a_bytes, b_bytes) else TILES


def tile_id(bm: int, bn: int, bk: int, tiles: tuple = TILES) -> int:
    """The C entries' id of a tile of ``tiles`` (its index in TILES)."""
    if (bm, bn, bk) not in tiles:
        raise ValueError(f"({bm}, {bn}, {bk}) is not a compiled tile; "
                         f"the menu is {tiles}")
    return TILES.index((bm, bn, bk))


def mkn(trans: str, a_shape, b_shape) -> tuple[int, int, int]:
    if trans == "nn":
        (m, k), (_, n) = a_shape, b_shape
    elif trans == "tn":
        (k, m), (_, n) = a_shape, b_shape
    elif trans == "nt":
        (m, k), (n, _) = a_shape, b_shape
    else:
        raise ValueError(f"unknown trans: {trans!r}")
    return m, k, n


# ---------------------------------------------------------------------------
# Launch grids: the grid each C entry launches and what each CTA stores,
# for the static contracts (``analysis.contracts``).  The functions take
# numpy arrays of block indices (x, y, z) and mirror the kernels' own
# decode of blockIdx (csrc/ftimm_common.cuh: tile_coords_of, ragged_chunk;
# csrc/ftimm_gstream.cuh: group_stream_kernel).
# ---------------------------------------------------------------------------

TC_BM = 128         # ftimm_tc.cuh: tc::BM, the tensor-core tile's rows
PAIR_N = 128        # the SwiGLU pairs' tensor-core tile: output columns
# The kernels whose C entries take the grid order (``nm_order``); the
# others walk "mn" whatever the plan says.
_ORDERED = {("ftimm_gemm", "fma"), ("ftimm_gemm", "tc"),
            ("ftimm_gemm_swiglu", "tc"), ("ftimm_gemm_grouped", "fma"),
            ("ftimm_gemm_grouped", "tc"), ("ftimm_gemm_splitk", "fma"),
            ("ftimm_gemm_splitk", "tc")}
_RAGGED = ("ftimm_gemm_ragged", "ftimm_gemm_ragged_swiglu")
_GROUP_STREAM = {"ftimm_gemm_swiglu", "ftimm_gemm_grouped",
                 "ftimm_gemm_grouped_swiglu", *_RAGGED}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_coords_of(t, bm: int, bn: int, m: int, n: int, nm_order: bool):
    """(row tile, column tile) of tile ``t`` of the (M, N) grid, M outer
    ("mn") or N outer ("nm"): csrc/ftimm_common.cuh, tile_coords_of."""
    gm, gn = _cdiv(m, bm), _cdiv(n, bn)
    return (t % gm, t // gm) if nm_order else (t // gn, t % gn)


@dataclass(frozen=True)
class LaunchGrid:
    """One launch as its C entry sets it up.  ``grid``: the CUDA grid (x,
    y, z).  ``arrival(x, y, z)`` -> (counter, slice): the CTAs that share
    a counter sum ``slices`` K slices into one output, the last to arrive
    storing it (a kernel without slices: one counter per CTA, slice 0).
    ``store(x, y, z)`` -> the output tile a CTA stores, as a tuple of index
    arrays over ``out_extent``.  The ragged forward kernels store rows that
    the device offsets decide: ``store`` is None and ``rows(x, y, z,
    offsets)`` -> (group, lo, hi, skip_lo, skip_hi) says that a CTA writes
    rows [lo, hi) but [skip_lo, skip_hi) (its zero-fill slot skips the
    rows some group owns), every column tile alike."""
    kernel: str
    body: str
    grid: tuple[int, int, int]
    out_extent: tuple[int, ...]
    slices: int
    arrival: Callable
    store: Callable | None = None
    rows: Callable | None = None


def _one_per_cta(grid):
    """Each CTA its own counter, slice 0."""
    gx, gy, _ = grid
    return lambda x, y, z: (x + gx * (y + gy * z), 0 * x)


def _ragged_rows(bm: int, gn: int, t: int, g: int):
    """csrc/ftimm_common.cuh, ragged_chunk (and ragged_zero_fill): CTA (x,
    y) owns chunk x // gn of group y's rows, y == G the rows of chunk x //
    gn that no group owns."""
    def rows(x, y, z, offsets):
        offs = np.asarray(offsets, dtype=np.int64)
        chunk = x // gn
        lo_all = np.clip(offs[0], 0, t)
        hi_all = np.clip(offs[g], lo_all, t)
        yg = np.minimum(y, g - 1) if g else y
        lo = np.clip(offs[yg], 0, t)
        hi = np.clip(offs[np.minimum(yg + 1, g)], lo, t)
        zero = y == g
        row0 = np.where(zero, chunk * bm, lo + chunk * bm)
        end = np.where(zero, np.minimum(row0 + bm, t),
                       np.minimum(row0 + bm, hi))
        end = np.maximum(end, row0)
        return (y, row0, end, np.where(zero, lo_all, 0),
                np.where(zero, hi_all, 0))
    return rows


def _gstream_rows(t: int, g: int):
    """csrc/ftimm_gstream.cuh, group_stream_kernel with offsets: slot z <
    G writes the first min(rows, 16) rows of group z (the last CTA of its
    counter); slot G, at slice 0 only, the rows no group owns."""
    def rows(x, y, z, offsets):
        offs = np.asarray(offsets, dtype=np.int64)
        lo_all = np.clip(offs[0], 0, t)
        hi_all = np.clip(offs[g], lo_all, t)
        zg = np.minimum(z, g - 1) if g else z
        lo = np.clip(offs[zg], 0, t)
        hi = np.clip(offs[np.minimum(zg + 1, g)], lo, t)
        zero = z == g
        row0 = np.where(zero, 0, lo)
        end = np.where(zero, np.where(y == 0, t, 0),
                       lo + np.minimum(hi - lo, GSTREAM_ROWS))
        return (z, row0, end, np.where(zero, lo_all, 0),
                np.where(zero, hi_all, 0))
    return rows


def launch_grid(kernel: str, body: str, dims, tile, *,
                dim_order: str = "mn", kslices: int = 1,
                nsplit: int = 1) -> LaunchGrid:
    """The grid ``kernel``'s ``body`` launches for ``dims`` ((M, K, N) for
    ``ftimm_gemm``, its pair and split-K; (G, M, K, N) grouped; (G, T, K,
    N) ragged; (G, T, D, F) the ragged dW) and the plan's ``tile`` (bm,
    bn, bk; a stream's bm is its row count), as the C entries set it:
    ftimm_gemm.cu (FMA, tensor cores, register stream), the grouped,
    ragged and pair entries, ftimm_gemm_ragged_dw.cu, ftimm_gemm_splitk.cu,
    ftimm_gstream.cuh's (strip, slice, group) grid and ftimm_rows.cuh's
    (N strip of ``tile[1]``, K slice of ``tile[2]``, group) grid."""
    bm, bn, _ = (int(v) for v in tile)
    nm = (kernel, body) in _ORDERED and dim_order == "nm"
    if body == "tc":
        bm = TC_BM
        if kernel not in ("ftimm_gemm", "ftimm_gemm_splitk",
                          "ftimm_gemm_ragged_dw"):
            bn = PAIR_N if "swiglu" in kernel else GROUP_TC_TILE[1]
    if body == "rows":      # ftimm_rows.cuh: (N strip, K slice, group)
        g, _, k, n = dims
        strips, slices = _cdiv(n, bn), max(_cdiv(k, int(tile[2])), 1)
        return LaunchGrid(kernel, body, (strips, slices, g), (g, strips),
                          slices, arrival=lambda x, y, z: (z * strips + x, y),
                          store=lambda x, y, z: (z, x))
    if body == "stream":
        if kernel in _GROUP_STREAM:
            return _group_stream_grid(kernel, dims, kslices)
        m, k, n = dims
        _, slices = stream_slice(k, kslices)
        strips = _cdiv(n, STREAM_STRIP)
        return LaunchGrid(kernel, body, (strips, slices, 1),
                          (_cdiv(m, bm), strips), slices,
                          arrival=lambda x, y, z: (x, y),
                          store=lambda x, y, z: (0 * x, x))
    if kernel in _RAGGED:
        g, t, _, n = dims
        gn = _cdiv(n, bn)
        grid = (_cdiv(t, bm) * gn, g + 1, 1)
        return LaunchGrid(kernel, body, grid, (t, gn), 1,
                          arrival=_one_per_cta(grid),
                          rows=_ragged_rows(bm, gn, t, g))
    if kernel == "ftimm_gemm_ragged_dw":
        g, _, d, f = dims
        gm, gn = _cdiv(d, bm), _cdiv(f, bn)
        grid = (gm * gn, g, 1)
        return LaunchGrid(
            kernel, body, grid, (g, gm, gn), 1, arrival=_one_per_cta(grid),
            store=lambda x, y, z: (y, *tile_coords_of(x, bm, bn, d, f,
                                                      False)))
    if kernel == "ftimm_gemm_splitk":
        m, _, n = dims
        gm, gn = _cdiv(m, bm), _cdiv(n, bn)
        if body == "tc":    # blockIdx.x = tile * nsplit + split
            grid = (gm * gn * nsplit, 1, 1)
            return LaunchGrid(
                kernel, body, grid, (gm, gn), nsplit,
                arrival=lambda x, y, z: (x // nsplit, x % nsplit),
                store=lambda x, y, z: tile_coords_of(x // nsplit, bm, bn, m,
                                                     n, nm))
        grid = (gm * gn, 1, nsplit)     # split z writes partial plane z
        return LaunchGrid(
            kernel, body, grid, (nsplit, gm, gn), 1,
            arrival=_one_per_cta(grid),
            store=lambda x, y, z: (z, *tile_coords_of(x, bm, bn, m, n, nm)))
    if kernel in ("ftimm_gemm", "ftimm_gemm_swiglu"):
        m, _, n = dims
        gm, gn = _cdiv(m, bm), _cdiv(n, bn)
        grid = (gm * gn, 1, 1)
        return LaunchGrid(kernel, body, grid, (gm, gn), 1,
                          arrival=_one_per_cta(grid),
                          store=lambda x, y, z: tile_coords_of(x, bm, bn, m,
                                                               n, nm))
    if kernel in ("ftimm_gemm_grouped", "ftimm_gemm_grouped_swiglu"):
        g, m, _, n = dims
        gm, gn = _cdiv(m, bm), _cdiv(n, bn)
        grid = (gm * gn, 1, g)
        return LaunchGrid(
            kernel, body, grid, (g, gm, gn), 1, arrival=_one_per_cta(grid),
            store=lambda x, y, z: (z, *tile_coords_of(x, bm, bn, m, n, nm)))
    raise ValueError(f"no launch grid for {kernel!r} ({body} body)")


def _group_stream_grid(kernel: str, dims, kslices: int) -> LaunchGrid:
    """ftimm_gstream.cuh's grid (128-column strip, K slice, group slot): one
    slot for the dense pair, G for the grouped kernels, G + 1 for the
    ragged (the last zero-fills the rows no group owns)."""
    if kernel == "ftimm_gemm_swiglu":
        (m, k, n), g = dims, 1
    else:
        g, m, k, n = dims
    _, slices = stream_slice(k, kslices)
    strips = _cdiv(n, STREAM_STRIP)

    def arrival(x, y, z):
        return z * strips + x, y

    if kernel in _RAGGED:
        return LaunchGrid(kernel, "stream", (strips, slices, g + 1),
                          (m, strips), slices, arrival=arrival,
                          rows=_gstream_rows(m, g))
    if kernel == "ftimm_gemm_swiglu":
        return LaunchGrid(kernel, "stream", (strips, slices, 1),
                          (_cdiv(m, GSTREAM_ROWS), strips), slices,
                          arrival=arrival, store=lambda x, y, z: (0 * x, x))
    return LaunchGrid(kernel, "stream", (strips, slices, g),
                      (g, _cdiv(m, GSTREAM_ROWS), strips), slices,
                      arrival=arrival, store=lambda x, y, z: (z, 0 * x, x))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the ftIMM CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {kernel: library path}; raises
    with the compiler's output when a build fails.  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) stays in a ``.log``
    beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        if proc.wait() != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    if failed:
        raise RuntimeError("ftIMM kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "ftimm_gemm": [_I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _LL, _LL, _LL, _LL,
                   _I, _VP, _I, _F, _VP, _I, _VP, _VP],
    "ftimm_gemm_tc": [_I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _LL, _LL, _LL,
                      _LL, _I, _VP, _I, _F, _VP, _I, _VP, _VP],
    "ftimm_gemm_stream": [_I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _LL, _LL,
                          _LL, _LL, _I, _I, _VP, _VP, _VP, _I, _F, _VP, _I,
                          _VP, _VP],
    "ftimm_gemm_swiglu": [_I, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _LL, _LL,
                          _LL, _LL, _VP],
    "ftimm_gemm_grouped": [_I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _LL, _LL,
                           _LL, _LL, _LL, _LL, _I, _VP, _LL, _I, _F, _VP, _LL,
                           _I, _VP, _VP],
    "ftimm_gemm_grouped_stream": [_I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _LL,
                                  _LL, _LL, _LL, _LL, _LL, _I, _I, _VP, _VP,
                                  _VP, _LL, _I, _F, _VP, _LL, _I, _VP, _VP],
    "ftimm_gemm_grouped_rows": [_I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _LL,
                                _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _VP, _VP,
                                _VP, _LL, _I, _F, _VP, _LL, _I, _VP, _VP],
    "ftimm_gemm_grouped_swiglu": [_I, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I,
                                  _I, _LL, _LL, _LL, _LL, _LL, _LL, _VP],
    "ftimm_gemm_ragged": [_I, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _LL,
                          _LL, _LL, _LL, _LL, _VP, _LL, _I, _F, _VP, _LL, _I,
                          _VP],
    "ftimm_gemm_ragged_stream": [_I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                 _LL, _LL, _LL, _LL, _LL, _I, _I, _VP, _VP,
                                 _VP, _LL, _I, _F, _VP, _LL, _I, _VP],
    "ftimm_gemm_ragged_swiglu": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _I, _I,
                                 _I, _I, _LL, _LL, _LL, _LL, _LL, _VP],
    "ftimm_gemm_ragged_dw": [_I, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _VP],
    "ftimm_gemm_ragged_dw_tc": [_I, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I,
                                _I, _LL, _LL, _LL, _LL, _VP],
    "ftimm_gemm_splitk": [_I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _I, _LL,
                          _LL, _LL, _LL, _I, _VP],
    "ftimm_gemm_splitk_tc": [_I, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _I, _VP, _VP, _VP, _I, _F,
                             _VP, _I, _VP, _VP],
}
# The grouped and ragged tensor-core entries (and their pairs') take their
# FMA entry's arguments but the tile: they run GROUP_TC_TILE.  The pairs'
# stream entries add (slices, slice, workspace, counters) before the stream.
for _name in ("ftimm_gemm_grouped", "ftimm_gemm_ragged",
              "ftimm_gemm_grouped_swiglu", "ftimm_gemm_ragged_swiglu"):
    _ARGTYPES[f"{_name}_tc"] = [_I] + _ARGTYPES[_name][2:]
for _name in ("ftimm_gemm_swiglu", "ftimm_gemm_grouped_swiglu",
              "ftimm_gemm_ragged_swiglu"):
    _ARGTYPES[f"{_name}_stream"] = ([_I] + _ARGTYPES[_name][2:-1]
                                    + [_I, _I, _VP, _VP, _VP])
# The dense pair's tensor-core entry: its FMA entry's arguments but the
# tile, and the grid order.
_ARGTYPES["ftimm_gemm_swiglu_tc"] = ([_I] + _ARGTYPES["ftimm_gemm_swiglu"][2:-1]
                                     + [_I, _VP])
_entries: dict[str, object] = {}
_libs: list[ctypes.CDLL] = []     # keeps the loaded libraries alive


def _entry(name: str, body: str = "fma"):
    """The C entry of ``name``'s ``body``: ``<name>_launch`` for the FMA
    body, ``<name>_<body>_launch`` for the others, from the kernel's one
    library."""
    key = name if body == "fma" else f"{name}_{body}"
    fn = _entries.get(key)
    if fn is None:
        lib = ctypes.CDLL(str(build()[name]))
        _libs.append(lib)
        fn = getattr(lib, f"{key}_launch")
        fn.argtypes = _ARGTYPES[key]
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def _launch(name: str, device: torch.device, *args, body: str = "fma") -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry(name, body)(device.index or 0, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} ({body} body) launch failed: CUDA error "
                           f"{err}")
    _launches[name] += 1
    if (name, body) in _body_launches:
        _body_launches[(name, body)] += 1


_stream_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The stream bodies' arrival counters (one per strip; the grouped and
    ragged streams: one per group and strip) for the current CUDA
    stream of ``device``: zeros between launches (the last CTA of a strip
    resets its own), kept across calls, grown when a call has more strips.
    One buffer per CUDA stream, so launches that share it run one after
    another and never count each other's arrivals."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _stream_counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _stream_counters[key] = buf
    return buf


def _cuda_operands(name: str, a: torch.Tensor, b: torch.Tensor, out_dtype,
                   *others) -> int:
    """Check what the CUDA kernels take; return the type code."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {a.device} have no kernel "
                         "(CPU tensors take the plain version)")
    for t in (b, *others):
        if t is not None and t.device != a.device:
            raise ValueError(f"{name}: operands on {a.device} and {t.device}")
    code = _TYPE_CODES.get((a.dtype, b.dtype, out_dtype))
    if (code is None or (3 <= code <= 6 and name not in _MIXED)
            or (code >= 7 and code not in _QUANT.get(name, ()))):
        raise NotImplementedError(
            f"{name}: {a.dtype} x {b.dtype} -> {out_dtype} has no kernel "
            "(bf16 -> bf16/fp32 and fp32 -> fp32 are built, and bf16 x fp32 "
            "in either order for the kernels with independent operands; "
            "the quantized pairs -- bf16/fp32 x int8, int8 x int8 and fp8 x "
            "fp8, to bf16/fp32 -- for ftimm_gemm and ftimm_gemm_ragged, and "
            "the straight-through dX, bf16/fp32 x fp8 to fp32, for "
            "ftimm_gemm; only their FMA bodies take 1-byte operands)")
    return code


def _vec(v: torch.Tensor | None) -> torch.Tensor | None:
    return None if v is None else v.to(torch.float32).contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _residual(residual, shape, dtype) -> torch.Tensor | None:
    """The residual as the kernel reads it: contiguous, of A's dtype -- or,
    when A is a 1-byte quantized operand, any float type widened to fp32
    (exact; the kernel reads an fp32 residual then, ResidualOf in csrc)."""
    if residual is None:
        return None
    if tuple(residual.shape) != tuple(shape) or not residual.is_contiguous():
        raise ValueError(f"residual must be contiguous {tuple(shape)}, got "
                         f"{tuple(residual.shape)}")
    if torch.tensor([], dtype=dtype).element_size() == 1 \
            and residual.dtype in (_BF16, _F32):
        return residual.to(_F32)
    if residual.dtype != dtype:
        raise ValueError(f"residual must have A's dtype {dtype}, "
                         f"got {residual.dtype}")
    return residual


def vector_shapes(n: int, g: int | None = None) -> tuple:
    """The shapes a flush vector (bias, scale) may take: (N,), broadcast
    over the rows, and for the grouped and ragged kernels (``g`` groups)
    also (G, N), one row per group."""
    return ((n,),) if g is None else ((n,), (g, n))


def check_vectors(epilogue: Epilogue, bias, scale, n: int,
                  g: int | None = None) -> None:
    """Raise ValueError when a flush vector the epilogue takes is not of
    ``vector_shapes(n, g)``."""
    for flag, v in ((epilogue.bias, bias), (epilogue.scale_vec, scale)):
        if flag and v is not None and tuple(v.shape) not in vector_shapes(
                n, g):
            want = vector_shapes(n, g)
            raise ValueError(f"epilogue vector {tuple(v.shape)} is not "
                             + " nor ".join(str(s) for s in want))


def _epi_scalars(epi: Epilogue) -> tuple[int, float, int]:
    return (int(epi.scale is not None),
            0.0 if epi.scale is None else float(epi.scale),
            _ACT_CODES[epi.activation])


# ---------------------------------------------------------------------------
# Dense GEMM  (replaces src/repro/kernels/ftimm/kernel.py:ftimm_gemm)
# ---------------------------------------------------------------------------

def ftimm_gemm_plain(a, b, *, trans: str = "nn", out_dtype=None,
                     epilogue: Epilogue = IDENTITY, bias=None, residual=None,
                     scale=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm``: fp32-accumulating matmul, the
    epilogue on the fp32 result, then the output cast."""
    out_dtype = out_dtype or a.dtype
    if epilogue.is_identity:
        return ref.REF[trans](a, b, out_dtype)
    z = ref.REF[trans](a, b, torch.float32)
    return epilogue.apply(z, bias=bias, residual=residual,
                          scale=scale).to(out_dtype)


def ftimm_gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int, bk: int,
               trans: str = "nn", dim_order: str = "mn", out_dtype=None,
               epilogue: Epilogue = IDENTITY, bias=None, residual=None,
               scale=None, body: str = "fma", kslices: int = 1) -> torch.Tensor:
    """C = epi(op(A) . op(B)) -> (M, N).  trans "nn": A (M,K), B (K,N);
    "tn": A (K,M); "nt": B (N,K).  Operands may be any strided 2-D views.
    ``bias`` / ``scale`` (N,) and ``residual`` (M, N) ride along when the
    epilogue asks for them; the residual has A's dtype.  A and B may be
    bf16 and fp32 in either order (the product of their exact values).

    ``body``: "fma" runs the (bm, bn, bk) tile of TILES; "tc" the (bm, bn,
    bk) tile of TC_TILES; "stream" cuts K into ``kslices`` slices
    (``stream_slice``) and ignores the tile.  A body the operands do not
    allow (``gemm_bodies``) raises."""
    m, k, n = mkn(trans, a.shape, b.shape)
    out_dtype = out_dtype or a.dtype
    if a.device.type in PLAIN_DEVICES:
        return ftimm_gemm_plain(a, b, trans=trans, out_dtype=out_dtype,
                                epilogue=epilogue, bias=bias,
                                residual=residual, scale=scale)
    bias = bias if epilogue.bias else None
    scale = scale if epilogue.scale_vec else None
    types = _cuda_operands("ftimm_gemm", a, b, out_dtype, bias, residual, scale)
    res = _residual(residual if epilogue.residual else None, (m, n), a.dtype)
    bias32, scale32 = _vec(bias), _vec(scale)
    sam, sak, sbk, sbn = op_strides(trans, a, b)
    if body != "fma" and body not in gemm_bodies(
            a.element_size(), b.element_size(), m,
            *gemm_operands_ok(a, b, trans)):
        raise ValueError(f"ftimm_gemm: the {body} body cannot take "
                         f"{a.dtype} x {b.dtype}, M = {m}, strides "
                         f"{a.stride()} x {b.stride()} ({trans})")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    has_scale, scale_val, act = _epi_scalars(epilogue)
    epi = (_ptr(scale32), has_scale, scale_val, _ptr(bias32), act, _ptr(res))
    if body == "fma":
        tile = tile_id(bm, bn, bk, fma_tiles(a.element_size(),
                                             b.element_size()))
        _launch("ftimm_gemm", a.device, tile, types, a.data_ptr(),
                b.data_ptr(), c.data_ptr(), m, n, k, sam, sak, sbk, sbn,
                int(dim_order == "nm"), *epi)
    elif body == "tc":
        if (bm, bn, bk) not in TC_TILES:
            raise ValueError(f"({bm}, {bn}, {bk}) is not a tensor-core tile; "
                             f"the menu is {TC_TILES}")
        _launch("ftimm_gemm", a.device, TC_TILES.index((bm, bn, bk)), types,
                a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, sam, sak,
                sbk, sbn, int(dim_order == "nm"), *epi, body="tc")
    elif body == "stream":
        rows = stream_rows(m)
        sl, slices = stream_slice(k, kslices)
        if rows * sl * 2 > STREAM_SMEM or slices > 65535:
            raise ValueError(f"ftimm_gemm: a stream slice of {sl} x {rows} "
                             f"rows exceeds {STREAM_SMEM} bytes (K = {k}, "
                             f"{kslices} slices)")
        strips = -(-n // STREAM_STRIP)
        ws = (torch.empty((slices, m, n), dtype=torch.float32,
                          device=a.device) if slices > 1 else None)
        counters = _counters(a.device, strips) if slices > 1 else None
        _launch("ftimm_gemm", a.device, rows, types, a.data_ptr(),
                b.data_ptr(), c.data_ptr(), m, n, k, sam, sak, sbk, sbn,
                slices, sl, _ptr(ws), _ptr(counters), *epi, body="stream")
    else:
        raise ValueError(f"unknown body: {body!r}")
    return c


# ---------------------------------------------------------------------------
# Fused SwiGLU pair  (replaces kernel.py:ftimm_gemm_swiglu)
# ---------------------------------------------------------------------------

def ftimm_gemm_swiglu_plain(x, w_gate, w_up, *, out_dtype=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_swiglu``."""
    g = ref.matmul_nn(x, w_gate, torch.float32)
    u = ref.matmul_nn(x, w_up, torch.float32)
    return (g * torch.sigmoid(g) * u).to(out_dtype or x.dtype)


def ftimm_gemm_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, *, bm: int, bn: int, bk: int,
                      out_dtype=None, body: str = "fma", kslices: int = 1,
                      dim_order: str = "mn") -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu): x (M, K), both panels (K, N) -> (M, N).

    ``body``: "fma" runs the (bm, bn, bk) tile of TILES; "tc" runs
    GROUP_TC_TILE (both panels into one stage, walked in ``dim_order``)
    and "stream" the group stream with one group, K cut into ``kslices``
    slices (``stream_slice``), both whatever the tile.  A body the
    operands do not allow (``gemm_bodies`` with ``panels`` = 2: x and
    both panels TMA-readable bf16, x K-major; the stream at most
    GSTREAM_ROWS rows) raises."""
    m, k = x.shape
    kw, n = w_gate.shape
    if kw != k or w_up.shape != w_gate.shape:
        raise ValueError(f"swiglu shapes {tuple(x.shape)} x "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type in PLAIN_DEVICES:
        return ftimm_gemm_swiglu_plain(x, w_gate, w_up, out_dtype=out_dtype)
    name = "ftimm_gemm_swiglu"
    types = _cuda_operands(name, x, w_gate, out_dtype, w_up)
    if w_up.dtype != x.dtype or w_up.stride() != w_gate.stride():
        raise ValueError("swiglu panels must share dtype and layout")
    if body != "fma" and body not in gemm_bodies(
            x.element_size(), w_gate.element_size(), m,
            *swiglu_operands(x, w_gate, w_up), panels=2):
        raise ValueError(f"{name}: the {body} body cannot take {x.dtype} x "
                         f"{w_gate.dtype}, M = {m}, strides {x.stride()} x "
                         f"{w_gate.stride()}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    operands = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                out.data_ptr(), m, n, k, x.stride(0), x.stride(1),
                w_gate.stride(0), w_gate.stride(1))
    if body == "fma":
        _launch(name, x.device, tile_id(bm, bn, bk), types, *operands)
    elif body == "tc":
        _launch(name, x.device, types, *operands, int(dim_order == "nm"),
                body="tc")
    elif body == "stream":
        sl, slices, ws, counters = _stream_plan(name, x.device, k, kslices,
                                                m, n, 1, panels=2)
        _launch(name, x.device, types, *operands, slices, sl, _ptr(ws),
                _ptr(counters), body="stream")
    else:
        raise ValueError(f"unknown body: {body!r}")
    return out


# ---------------------------------------------------------------------------
# Grouped GEMM  (replaces kernel.py:ftimm_gemm_grouped / ftimm_gemm_batched)
# ---------------------------------------------------------------------------

def _per_group(v):
    """(G, N) per-group vectors broadcast over the rows of (G, M, N)."""
    return v if v is None or v.ndim == 1 else v.unsqueeze(-2)


def ftimm_gemm_grouped_plain(a, b, *, trans: str = "nn", out_dtype=None,
                             epilogue: Epilogue = IDENTITY, bias=None,
                             residual=None, scale=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_grouped`` (a 2-D operand broadcasts
    over the groups)."""
    out_dtype = out_dtype or a.dtype
    z = ref.REF[trans](a, b, torch.float32)
    if not epilogue.is_identity:
        z = epilogue.apply(z, bias=_per_group(bias), residual=residual,
                           scale=_per_group(scale))
    return z.to(out_dtype)


def _stream_plan(name: str, device, k: int, kslices: int, rows: int,
                 n: int, groups: int, panels: int = 1
                 ) -> tuple[int, int, torch.Tensor | None,
                            torch.Tensor | None]:
    """(slice, slices, workspace, counters) of the grouped / ragged weight
    stream: with more than one K slice the (slices, panels x rows, N) fp32
    partials (the SwiGLU pair keeps both panels') and one arrival counter
    per (group, strip).  Raises on a count the grid cannot hold."""
    sl, slices = stream_slice(k, kslices)
    if slices > 65535:
        raise ValueError(f"{name}: {slices} K slices exceed the grid's y "
                         "extent")
    if slices == 1:
        return sl, slices, None, None
    ws = torch.empty((slices, panels * rows, n), dtype=torch.float32,
                     device=device)
    return sl, slices, ws, _counters(device, groups * -(-n // STREAM_STRIP))


def ftimm_gemm_grouped(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                       bk: int, trans: str = "nn", dim_order: str = "mn",
                       out_dtype=None, epilogue: Epilogue = IDENTITY,
                       bias=None, residual=None, scale=None,
                       body: str = "fma",
                       kslices: int = 1) -> torch.Tensor:
    """Grouped GEMM -> (G, M, N).  Either operand may be 3-D (one panel per
    group) or 2-D (one panel shared by every group); at least one is 3-D.
    ``bias`` / ``scale`` are (N,) shared or (G, N) per group, ``residual``
    (G, M, N).

    ``body``: "fma" runs the (bm, bn, bk) tile of TILES; "tc" runs
    GROUP_TC_TILE and "stream" cuts K into ``kslices`` slices
    (``stream_slice``), both whatever the tile; "rows" (fp32, trans "nn" /
    "nt") cuts the call as its tile (``rows_tile``: (ROWS_MAX, N per CTA,
    K per slice)).  A body the operands do not allow (``grouped_bodies``)
    raises."""
    if a.ndim not in (2, 3) or b.ndim not in (2, 3) or a.ndim + b.ndim < 5:
        raise ValueError(f"grouped GEMM needs a 3-D operand: {tuple(a.shape)}"
                         f" x {tuple(b.shape)}")
    if a.ndim == 3 and b.ndim == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"group counts differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    g = a.shape[0] if a.ndim == 3 else b.shape[0]
    m, k, n = mkn(trans, a.shape[-2:], b.shape[-2:])
    out_dtype = out_dtype or a.dtype
    check_vectors(epilogue, bias, scale, n, g)
    if a.device.type in PLAIN_DEVICES:
        return ftimm_gemm_grouped_plain(a, b, trans=trans, out_dtype=out_dtype,
                                        epilogue=epilogue, bias=bias,
                                        residual=residual, scale=scale)
    bias = bias if epilogue.bias else None
    scale = scale if epilogue.scale_vec else None
    types = _cuda_operands("ftimm_gemm_grouped", a, b, out_dtype, bias,
                           residual, scale)
    if g > 65535:
        raise ValueError(f"{g} groups exceed the grid's z extent (65535)")
    if body != "fma" and body not in grouped_bodies(
            a.element_size(), b.element_size(), m,
            *grouped_operands(a, b, trans), trans=trans,
            b_rows=rows_operand(b)):
        raise ValueError(f"ftimm_gemm_grouped: the {body} body cannot take "
                         f"{a.dtype} x {b.dtype}, M = {m}, strides "
                         f"{a.stride()} x {b.stride()} ({trans})")
    res = _residual(residual if epilogue.residual else None, (g, m, n),
                    a.dtype)
    bias32, scale32 = _vec(bias), _vec(scale)
    sag, sam, sak = _group_strides(a, trans != "tn")
    sbg, sbk, sbn = _group_strides(b, trans != "nt")
    c = torch.empty((g, m, n), dtype=out_dtype, device=a.device)
    if g == 0 or m == 0 or n == 0:
        return c
    has_scale, scale_val, act = _epi_scalars(epilogue)
    epi = (_ptr(scale32), 0 if scale is None or scale.ndim == 1 else n,
           has_scale, scale_val, _ptr(bias32),
           0 if bias is None or bias.ndim == 1 else n, act, _ptr(res))
    operands = (a.data_ptr(), b.data_ptr(), c.data_ptr(), g, m, n, k, sag,
                sam, sak, sbg, sbk, sbn)
    if body == "fma":
        _launch("ftimm_gemm_grouped", a.device, tile_id(bm, bn, bk), types,
                *operands, int(dim_order == "nm"), *epi)
    elif body == "tc":
        _launch("ftimm_gemm_grouped", a.device, types, *operands,
                int(dim_order == "nm"), *epi, body="tc")
    elif body == "stream":
        sl, slices, ws, counters = _stream_plan(
            "ftimm_gemm_grouped", a.device, k, kslices, g * m, n, g)
        _launch("ftimm_gemm_grouped", a.device, types, *operands,
                slices, sl, _ptr(ws), _ptr(counters), *epi, body="stream")
    elif body == "rows":
        if not rows_tile_ok(bm, bn, bk, trans):
            raise ValueError(f"({bm}, {bn}, {bk}) is not a rows tile for "
                             f"{trans!r} (rows_tile)")
        nt = trans == "nt"
        width, span = (bk, bn) if nt else (bn, bk)
        slices = max(-(-k // bk), 1)
        if slices > 65535:
            raise ValueError(f"ftimm_gemm_grouped: {slices} K slices exceed "
                             "the grid's y extent")
        ws = (torch.empty((slices, g, m, n), dtype=torch.float32,
                          device=a.device) if slices > 1 else None)
        counters = _counters(a.device, g * -(-n // bn)) if slices > 1 else None
        _launch("ftimm_gemm_grouped", a.device, types, *operands, int(nt),
                width, span, _ptr(ws), _ptr(counters), *epi, body="rows")
    else:
        raise ValueError(f"unknown body: {body!r}")
    return c


# ---------------------------------------------------------------------------
# Grouped fused SwiGLU pair  (replaces kernel.py:ftimm_gemm_grouped_swiglu)
# ---------------------------------------------------------------------------

def ftimm_gemm_grouped_swiglu_plain(x, w_gate, w_up, *,
                                    out_dtype=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_grouped_swiglu``: the dense pair's
    arithmetic with a group axis (a 2-D ``x`` broadcasts over the groups)."""
    return ftimm_gemm_swiglu_plain(x, w_gate, w_up, out_dtype=out_dtype)


def ftimm_gemm_grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                              w_up: torch.Tensor, *, bm: int, bn: int,
                              bk: int, out_dtype=None, body: str = "fma",
                              kslices: int = 1) -> torch.Tensor:
    """silu(x_g @ Wg_g) * (x_g @ Wu_g) per group -> (G, M, N).  ``x`` is
    (G, M, K), or (M, K) shared by every group; both panels (G, K, N).

    ``body``: "fma" runs the (bm, bn, bk) tile of TILES; "tc" runs
    GROUP_TC_TILE (both panels into one stage) and "stream" cuts K into
    ``kslices`` slices (``stream_slice``), both whatever the tile.  A body
    the operands do not allow (``grouped_bodies``, each panel as op(B))
    raises."""
    if (x.ndim not in (2, 3) or w_gate.ndim != 3
            or w_up.shape != w_gate.shape or x.shape[-1] != w_gate.shape[1]
            or (x.ndim == 3 and x.shape[0] != w_gate.shape[0])):
        raise ValueError(f"grouped swiglu shapes {tuple(x.shape)} x "
                         f"{tuple(w_gate.shape)} / {tuple(w_up.shape)}")
    g, k, n = w_gate.shape
    m = x.shape[-2]
    out_dtype = out_dtype or x.dtype
    if x.device.type in PLAIN_DEVICES:
        return ftimm_gemm_grouped_swiglu_plain(x, w_gate, w_up,
                                               out_dtype=out_dtype)
    name = "ftimm_gemm_grouped_swiglu"
    types = _cuda_operands(name, x, w_gate, out_dtype, w_up)
    if w_up.dtype != x.dtype or w_up.stride() != w_gate.stride():
        raise ValueError("swiglu panels must share dtype and layout")
    if g > 65535:
        raise ValueError(f"{g} groups exceed the grid's z extent (65535)")
    if body != "fma":
        a_major, g_ok = grouped_operands(x, w_gate, "nn")
        if body not in grouped_bodies(x.element_size(), w_gate.element_size(),
                                      m, a_major,
                                      g_ok and grouped_operands(x, w_up,
                                                                "nn")[1]):
            raise ValueError(f"{name}: the {body} body cannot take "
                             f"{x.dtype} x {w_gate.dtype}, M = {m}, strides "
                             f"{x.stride()} x {w_gate.stride()}")
    out = torch.empty((g, m, n), dtype=out_dtype, device=x.device)
    if g == 0 or m == 0 or n == 0:
        return out
    operands = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                out.data_ptr(), g, m, n, k, x.stride(0) if x.ndim == 3 else 0,
                x.stride(-2), x.stride(-1), *w_gate.stride())
    if body == "fma":
        _launch(name, x.device, tile_id(bm, bn, bk), types, *operands)
    elif body == "tc":
        _launch(name, x.device, types, *operands, body="tc")
    elif body == "stream":
        sl, slices, ws, counters = _stream_plan(name, x.device, k, kslices,
                                                g * m, n, g, panels=2)
        _launch(name, x.device, types, *operands, slices, sl, _ptr(ws),
                _ptr(counters), body="stream")
    else:
        raise ValueError(f"unknown body: {body!r}")
    return out


# ---------------------------------------------------------------------------
# Ragged grouped GEMM and its SwiGLU pair  (replace kernel.py:ftimm_gemm_ragged
# and ftimm_gemm_ragged_swiglu).  ``group_offsets`` (G+1,) are the device
# prefix sums of the per-group row counts: non-decreasing, offsets[0] == 0,
# offsets[G] <= T; rows past offsets[G] belong to no group and come out as
# zeros.  The kernels read the offsets on the device themselves, so the host
# never waits for the routing (no visit list is built, unlike the TPU path).
# ---------------------------------------------------------------------------

def _ragged_shape(x, w, group_offsets, trans: str) -> tuple[int, int, int]:
    """(T, K, N) of a ragged call; raises on a shape mismatch."""
    if trans not in ("nn", "nt"):
        raise ValueError(f"ragged trans must be 'nn' or 'nt', got {trans!r}")
    if x.ndim != 2 or w.ndim != 3:
        raise ValueError(f"ragged GEMM needs x (T, K) and w 3-D: "
                         f"{tuple(x.shape)} x {tuple(w.shape)}")
    k, n = (w.shape[1], w.shape[2]) if trans == "nn" else (w.shape[2],
                                                            w.shape[1])
    if x.shape[1] != k or tuple(group_offsets.shape) != (w.shape[0] + 1,):
        raise ValueError(f"ragged shapes {tuple(x.shape)} x {tuple(w.shape)} "
                         f"({trans}), offsets {tuple(group_offsets.shape)}")
    return x.shape[0], k, n


def row_groups(group_offsets: torch.Tensor, t: int):
    """Each row's group (clamped into range) and whether any group owns it."""
    offs = group_offsets.to(torch.int64)
    rows = torch.arange(t, device=offs.device)
    gid = torch.searchsorted(offs[1:].contiguous(), rows, right=True)
    owned = (rows >= offs[0]) & (gid < offs.shape[0] - 1)
    return gid.clamp(max=max(offs.shape[0] - 2, 0)), owned


def ftimm_gemm_ragged_plain(x, w, group_offsets, *, trans: str = "nn",
                            out_dtype=None, epilogue: Epilogue = IDENTITY,
                            bias=None, scale=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_ragged``: the masked per-group oracle,
    then the epilogue on the rows a group owns (the (G, N) vectors picked
    by each row's group)."""
    out_dtype = out_dtype or x.dtype
    z = ref.ragged_matmul_ref(x, w, group_offsets, trans=trans,
                              out_dtype=torch.float32)
    if not epilogue.is_identity:
        gid, owned = row_groups(group_offsets, x.shape[0])

        def rows_of(v):
            return v if v is None or v.ndim == 1 else v[gid]

        z = torch.where(owned[:, None],
                        epilogue.apply(z, bias=rows_of(bias),
                                       scale=rows_of(scale)), 0.0)
    return z.to(out_dtype)


def ftimm_gemm_ragged(x: torch.Tensor, w: torch.Tensor,
                      group_offsets: torch.Tensor, *, bm: int, bn: int,
                      bk: int, trans: str = "nn", out_dtype=None,
                      epilogue: Epilogue = IDENTITY, bias=None,
                      scale=None, body: str = "fma",
                      kslices: int = 1) -> torch.Tensor:
    """y[o_g:o_{g+1}] = epi(x[o_g:o_{g+1}] . op(W_g)) -> (T, N).  ``w`` is
    (G, K, N) "nn" or (G, N, K) "nt"; ``bias`` / ``scale`` are (N,) shared
    or (G, N) per group.  There is no residual operand.  ``body`` as for
    ``ftimm_gemm_grouped`` (the rule: ``ragged_bodies``)."""
    t, k, n = _ragged_shape(x, w, group_offsets, trans)
    if epilogue.residual:
        raise ValueError("the ragged kernel has no residual operand")
    g = w.shape[0]
    out_dtype = out_dtype or x.dtype
    check_vectors(epilogue, bias, scale, n, g)
    if x.device.type in PLAIN_DEVICES:
        return ftimm_gemm_ragged_plain(x, w, group_offsets, trans=trans,
                                       out_dtype=out_dtype, epilogue=epilogue,
                                       bias=bias, scale=scale)
    bias = bias if epilogue.bias else None
    scale = scale if epilogue.scale_vec else None
    types = _cuda_operands("ftimm_gemm_ragged", x, w, out_dtype,
                           group_offsets, bias, scale)
    if g + 1 > 65535:
        raise ValueError(f"{g} groups exceed the grid's y extent (65534)")
    if body != "fma" and body not in ragged_bodies(
            x.element_size(), w.element_size(), t,
            *ragged_operands(x, w, trans)):
        raise ValueError(f"ftimm_gemm_ragged: the {body} body cannot take "
                         f"{x.dtype} x {w.dtype}, T = {t}, strides "
                         f"{x.stride()} x {w.stride()} ({trans})")
    offs = group_offsets.to(torch.int32).contiguous()
    bias32, scale32 = _vec(bias), _vec(scale)
    swk, swn = ((w.stride(1), w.stride(2)) if trans == "nn"
                else (w.stride(2), w.stride(1)))
    c = torch.empty((t, n), dtype=out_dtype, device=x.device)
    if t == 0 or n == 0:
        return c
    has_scale, scale_val, act = _epi_scalars(epilogue)
    operands = (x.data_ptr(), w.data_ptr(), offs.data_ptr(), c.data_ptr(), t,
                n, k, g, x.stride(0), x.stride(1), w.stride(0), swk, swn)
    epi = (_ptr(scale32), 0 if scale is None or scale.ndim == 1 else n,
           has_scale, scale_val, _ptr(bias32),
           0 if bias is None or bias.ndim == 1 else n, act)
    if body == "fma":
        tile = tile_id(bm, bn, bk, fma_tiles(x.element_size(),
                                             w.element_size()))
        _launch("ftimm_gemm_ragged", x.device, tile, types, *operands, *epi)
    elif body == "tc":
        _launch("ftimm_gemm_ragged", x.device, types, *operands, *epi,
                body="tc")
    elif body == "stream":
        sl, slices, ws, counters = _stream_plan(
            "ftimm_gemm_ragged", x.device, k, kslices, t, n, g)
        _launch("ftimm_gemm_ragged", x.device, types, *operands,
                slices, sl, _ptr(ws), _ptr(counters), *epi, body="stream")
    else:
        raise ValueError(f"unknown body: {body!r}")
    return c


def ftimm_gemm_ragged_swiglu_plain(x, w_gate, w_up, group_offsets, *,
                                   out_dtype=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_ragged_swiglu``."""
    return ref.ragged_swiglu_ref(x, w_gate, w_up, group_offsets,
                                 out_dtype=out_dtype)


def ftimm_gemm_ragged_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                             w_up: torch.Tensor, group_offsets: torch.Tensor,
                             *, bm: int, bn: int, bk: int,
                             out_dtype=None, body: str = "fma",
                             kslices: int = 1) -> torch.Tensor:
    """silu(x[o_g:o_{g+1}] @ Wg_g) * (x[o_g:o_{g+1}] @ Wu_g) -> (T, N); both
    panels (G, K, N).  ``body`` as for ``ftimm_gemm_grouped_swiglu`` (the
    rule: ``ragged_bodies``, each panel as W)."""
    t, k, n = _ragged_shape(x, w_gate, group_offsets, "nn")
    if w_up.shape != w_gate.shape:
        raise ValueError(f"swiglu panels {tuple(w_gate.shape)} / "
                         f"{tuple(w_up.shape)}")
    g = w_gate.shape[0]
    out_dtype = out_dtype or x.dtype
    if x.device.type in PLAIN_DEVICES:
        return ftimm_gemm_ragged_swiglu_plain(x, w_gate, w_up, group_offsets,
                                              out_dtype=out_dtype)
    name = "ftimm_gemm_ragged_swiglu"
    types = _cuda_operands(name, x, w_gate, out_dtype, w_up, group_offsets)
    if w_up.dtype != x.dtype or w_up.stride() != w_gate.stride():
        raise ValueError("swiglu panels must share dtype and layout")
    if g + 1 > 65535:
        raise ValueError(f"{g} groups exceed the grid's y extent (65534)")
    if body != "fma":
        x_k, g_ok = ragged_operands(x, w_gate, "nn")
        if body not in ragged_bodies(x.element_size(), w_gate.element_size(),
                                     t, x_k,
                                     g_ok and ragged_operands(x, w_up,
                                                              "nn")[1]):
            raise ValueError(f"{name}: the {body} body cannot take "
                             f"{x.dtype} x {w_gate.dtype}, T = {t}, strides "
                             f"{x.stride()} x {w_gate.stride()}")
    offs = group_offsets.to(torch.int32).contiguous()
    out = torch.empty((t, n), dtype=out_dtype, device=x.device)
    if t == 0 or n == 0:
        return out
    operands = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                offs.data_ptr(), out.data_ptr(), t, n, k, g, x.stride(0),
                x.stride(1), *w_gate.stride())
    if body == "fma":
        _launch(name, x.device, tile_id(bm, bn, bk), types, *operands)
    elif body == "tc":
        _launch(name, x.device, types, *operands, body="tc")
    elif body == "stream":
        sl, slices, ws, counters = _stream_plan(name, x.device, k, kslices,
                                                t, n, g, panels=2)
        _launch(name, x.device, types, *operands, slices, sl, _ptr(ws),
                _ptr(counters), body="stream")
    else:
        raise ValueError(f"unknown body: {body!r}")
    return out


# ---------------------------------------------------------------------------
# Ragged dW  (replaces kernel.py:ftimm_gemm_ragged_dw).  The ragged axis is
# the contraction: dW[g] = x[o_g:o_{g+1}]^T . dy[o_g:o_{g+1}] -> (G, D, F),
# same offsets contract as the ragged forward; an empty group gives a zero
# panel and rows past offsets[G] enter no panel.
# ---------------------------------------------------------------------------

def ftimm_gemm_ragged_dw_plain(x, dy, group_offsets, *,
                               out_dtype=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_ragged_dw``: the masked per-group
    oracle."""
    return ref.ragged_matmul_dw_ref(x, dy, group_offsets,
                                    out_dtype=out_dtype or x.dtype)


def ftimm_gemm_ragged_dw(x: torch.Tensor, dy: torch.Tensor,
                         group_offsets: torch.Tensor, *, bm: int, bn: int,
                         bk: int, out_dtype=None,
                         body: str = "fma") -> torch.Tensor:
    """x (T, D), dy (T, F) -> (G, D, F).  ``bm`` / ``bn`` tile the (D, F)
    panel, ``bk`` is the step over a group's rows (the tile's own): a tile
    of TILES for ``body`` "fma", of TC_TILES for "tc" (which raises when
    ``ragged_dw_bodies`` does not allow it)."""
    if (x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]
            or group_offsets.ndim != 1 or group_offsets.shape[0] < 1):
        raise ValueError(f"ragged dW shapes {tuple(x.shape)} x "
                         f"{tuple(dy.shape)}, offsets "
                         f"{tuple(group_offsets.shape)}")
    (t, d), f = x.shape, dy.shape[1]
    g = group_offsets.shape[0] - 1
    out_dtype = out_dtype or x.dtype
    if x.device.type in PLAIN_DEVICES:
        return ftimm_gemm_ragged_dw_plain(x, dy, group_offsets,
                                          out_dtype=out_dtype)
    types = _cuda_operands("ftimm_gemm_ragged_dw", x, dy, out_dtype,
                           group_offsets)
    if g > 65535:
        raise ValueError(f"{g} groups exceed the grid's y extent (65535)")
    if body == "fma":
        tile = tile_id(bm, bn, bk)
    elif body == "tc":
        if (bm, bn, bk) not in TC_TILES:
            raise ValueError(f"({bm}, {bn}, {bk}) is not a tensor-core tile; "
                             f"the menu is {TC_TILES}")
        if body not in ragged_dw_bodies(x.element_size(), dy.element_size(),
                                        *ragged_dw_operands_mn(x, dy)):
            raise ValueError(f"ftimm_gemm_ragged_dw: the tc body cannot take "
                             f"{x.dtype} x {dy.dtype}, strides {x.stride()} "
                             f"x {dy.stride()}")
        tile = TC_TILES.index((bm, bn, bk))
    else:
        raise ValueError(f"unknown body: {body!r}")
    offs = group_offsets.to(torch.int32).contiguous()
    out = torch.empty((g, d, f), dtype=out_dtype, device=x.device)
    if g == 0 or d == 0 or f == 0:
        return out
    _launch("ftimm_gemm_ragged_dw", x.device, tile, types, x.data_ptr(),
            dy.data_ptr(), offs.data_ptr(), out.data_ptr(), t, d, f, g,
            x.stride(0), x.stride(1), dy.stride(0), dy.stride(1), body=body)
    return out


# ---------------------------------------------------------------------------
# Split-K dense GEMM  (replaces kernel.py:ftimm_gemm_splitk)
# ---------------------------------------------------------------------------

def ftimm_gemm_splitk_plain(a, b, *, bk: int, nsplit: int, trans: str = "nn",
                            out_dtype=None, epilogue: Epilogue = IDENTITY,
                            bias=None, residual=None,
                            scale=None) -> torch.Tensor:
    """Plain version of ``ftimm_gemm_splitk``: the fp32 partials over the
    kernel's K split summed in split order, then the epilogue, then the
    cast."""
    z = ref.matmul_splitk(a, b, nsplit, bk=bk, trans=trans,
                          out_dtype=torch.float32)
    if not epilogue.is_identity:
        z = epilogue.apply(z, bias=bias, residual=residual, scale=scale)
    return z.to(out_dtype or a.dtype)


def ftimm_gemm_splitk(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                      bk: int, nsplit: int, trans: str = "nn",
                      dim_order: str = "mn", out_dtype=None,
                      epilogue: Epilogue = IDENTITY, bias=None,
                      residual=None, scale=None,
                      body: str = "fma") -> torch.Tensor:
    """K-parallel C = epi(sum_s op(A)[:, K_s] . op(B)[K_s, :]) -> (M, N),
    the fp32 partials summed in split order (no atomics on the output:
    replays are bit-identical) and the epilogue on the fp32 sum, as in the
    reference.  Operands as for ``ftimm_gemm``.

    ``body``: "fma" runs the (bm, bn, bk) tile of TILES and writes the
    (nsplit, M, N) partials, summed here; "tc" runs the (bm, bn, bk) tile
    of TC_TILES (K cut at its bk of 64) and sums the partials and applies
    the epilogue inside the kernel, for bf16 x bf16 operands TMA can read
    (``gemm_bodies``), and raises on others."""
    m, k, n = mkn(trans, a.shape, b.shape)
    out_dtype = out_dtype or a.dtype
    if nsplit < 1:
        raise ValueError(f"nsplit must be >= 1, got {nsplit}")
    if a.device.type in PLAIN_DEVICES:
        return ftimm_gemm_splitk_plain(a, b, bk=bk, nsplit=nsplit,
                                       trans=trans, out_dtype=out_dtype,
                                       epilogue=epilogue, bias=bias,
                                       residual=residual, scale=scale)
    bias = bias if epilogue.bias else None
    scale = scale if epilogue.scale_vec else None
    residual = residual if epilogue.residual else None
    types = _cuda_operands("ftimm_gemm_splitk", a, b, out_dtype, bias,
                           residual, scale)
    sam, sak, sbk, sbn = op_strides(trans, a, b)
    if body == "tc":
        # One CTA per (output tile, split); the last of a tile's splits to
        # finish sums the partials and applies the epilogue.
        if (bm, bn, bk) not in TC_TILES:
            raise ValueError(f"({bm}, {bn}, {bk}) is not a tensor-core tile;"
                             f" the menu is {TC_TILES}")
        if "tc" not in gemm_bodies(a.element_size(), b.element_size(), m,
                                   *gemm_operands_ok(a, b, trans)):
            raise ValueError(f"ftimm_gemm_splitk: the tc body cannot take "
                             f"{a.dtype} x {b.dtype}, strides {a.stride()} "
                             f"x {b.stride()} ({trans})")
        res = _residual(residual, (m, n), a.dtype)
        bias32, scale32 = _vec(bias), _vec(scale)
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
        if m == 0 or n == 0:
            return c
        ws = torch.empty((nsplit, m, n), dtype=torch.float32,
                         device=a.device)
        counters = _counters(a.device, -(-m // bm) * -(-n // bn))
        has_scale, scale_val, act = _epi_scalars(epilogue)
        _launch("ftimm_gemm_splitk", a.device, TC_TILES.index((bm, bn, bk)),
                types, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                nsplit, ref.k_per_split(k, bk, nsplit), sam, sak, sbk, sbn,
                int(dim_order == "nm"), ws.data_ptr(), counters.data_ptr(),
                _ptr(scale32), has_scale, scale_val, _ptr(bias32), act,
                _ptr(res), body="tc")
        return c
    if body != "fma":
        raise ValueError(f"ftimm_gemm_splitk has no {body!r} body")
    if nsplit > 65535:
        raise ValueError(f"{nsplit} splits exceed the grid's z extent")
    tile = tile_id(bm, bn, bk)
    partials = torch.empty((nsplit, m, n), dtype=torch.float32,
                           device=a.device)
    if m and n:
        _launch("ftimm_gemm_splitk", a.device, tile, types, a.data_ptr(),
                b.data_ptr(), partials.data_ptr(), m, n, k, nsplit,
                ref.k_per_split(k, bk, nsplit), sam, sak, sbk, sbn,
                int(dim_order == "nm"))
    z = partials.sum(dim=0)
    if not epilogue.is_identity:
        z = epilogue.apply(z, bias=bias, residual=residual, scale=scale)
    return z.to(out_dtype)
