"""Computation-to-memory-ratio (CMR) model -- paper Sec. IV-C, for Hopper.

The paper derives block sizes by maximizing the CMR of each on-chip memory
level under capacity limits.  On the H100 the levels are device memory ->
shared memory -> registers, one CTA per output tile, so the model estimates
per candidate tile:

  * device-memory traffic: each CTA reads its operand panels once (masked
    loads read nothing outside the matrix, so edges cost no traffic), the A
    panel once per N tile and the B panel once per M tile;
  * padded compute: a CTA runs whole tiles and whole K steps;
  * the share of the card the grid occupies: CTAs run in waves over the
    132 SMs, and a last partial wave (or a grid smaller than one wave)
    leaves SMs idle -- the GPU counterpart of the paper's per-shape upper
    bound on utilization.

Each body of the kernels runs at its own peak: the tensor cores' bf16 rate,
the CUDA cores' fp32 FMA rate, and the weight streams (bytes-bound by design,
their grids fill the SMs with K slices: ``ftimm_gemm``'s FMAs priced at the
FMA rate, the grouped / ragged stream's wgmma at the tensor cores').
The estimate only ranks tiles and bodies; it is not a claim about the
card's speed.

A plan placed on a mesh adds an interconnect term: the bytes a rank
sends over its NVLinks (``HopperSpec.link_bw``, the data sheet's 18
links) for the K-parallel reduction or the expert-parallel exchange
(``estimate_ep``, priced at the bottleneck rank).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from ...kernels.ftimm.kernel import (GSTREAM_ROWS, STREAM_STRIP,
                                     gstream_smem, smem_bytes, stream_rows,
                                     stream_slice)


def ceil_to(x: int, b: int) -> int:
    return -(-x // b) * b


def cdiv(x: int, b: int) -> int:
    return -(-x // b)


@dataclass(frozen=True)
class HopperSpec:
    """NVIDIA H100 SXM constants (NVIDIA's data sheet, dense rates)."""
    name: str = "h100_sxm"
    sms: int = 132
    smem_per_block: int = 232_448          # 227 KB usable by one block
    hbm_bw: float = 3.35e12                # bytes/s
    l2_bytes: float = 50e6
    peak_flops_bf16: float = 989e12        # tensor cores
    peak_flops_fp32: float = 67e12         # CUDA cores, FMA
    peak_ops_int32: float = 33.5e12        # CUDA cores, integer multiply-add
                                           # (NVIDIA's H100 white paper)
    # The interconnect term of a placed plan (the reference's ICI): the
    # H100 SXM's fourth-generation NVLink, 18 links of 50 GB/s both ways
    # together (900 GB/s a GPU, NVIDIA's data sheet) -- 25 GB/s a link in
    # each direction, the rate one rank sends at.
    nvlink_bw_per_link: float = 25e9       # bytes/s, one direction
    nvlink_links: int = 18

    @property
    def link_bw(self) -> float:
        """Bytes/s one GPU sends over all its NVLinks at once."""
        return self.nvlink_bw_per_link * self.nvlink_links

    def kernel_flops(self, body: str = "fma", in_bytes: int = 4,
                     fp8: bool = False) -> float:
        """Peak of the engine a kernel body uses: the tensor cores' bf16 rate
        for "tc"; CUDA-core fp32 FMAs for "fma" (every operand widened to
        fp32) and for "stream" (FMAs on the unpacked bf16 pairs); the FMA
        body's integer multiply-adds for int8 x int8 (``in_bytes`` 1, which
        sums in int32, and the rate ``calibrate`` fits ``flops_frac_int8``
        against).  fp8 x fp8 (``fp8``) is widened to fp32 and summed with
        fp32 FMAs, at their rate."""
        if body == "tc":
            return self.peak_flops_bf16
        if body == "fma" and in_bytes == 1 and not fp8:
            return self.peak_ops_int32
        return self.peak_flops_fp32

    def calibrated(self, flops_frac: float, bw_frac: float,
                   int8_frac: float | None = None) -> "HopperSpec":
        """The measured-effective view of this card: the peak rates scaled
        by the achievable-flops fraction (the 1-byte rate by its own
        ``int8_frac`` when the calibration fitted one) and the device-memory
        bandwidth by the effective fraction (``autotune.calibrate`` fits
        them).  Capacities and tiles stay nominal."""
        return replace(self, name=f"{self.name}+cal",
                       peak_flops_bf16=self.peak_flops_bf16 * flops_frac,
                       peak_flops_fp32=self.peak_flops_fp32 * flops_frac,
                       peak_ops_int32=self.peak_ops_int32
                       * (flops_frac if int8_frac is None else int8_frac),
                       hbm_bw=self.hbm_bw * bw_frac)


H100 = HopperSpec()
# A tensor-core CTA's TMA copies run several stages deep, so one CTA can
# draw more than its 1/132 share of device-memory bandwidth; the model
# grants it up to this many shares.  The FMA body's loads pass through
# registers and get their one share.  The value decides the small grids:
# at the bucket prefills' projections (128 rows) it plans the tensor-core
# 128 x 128 tile, where one share would plan an FMA tile that
# ``launch.sweep_gemm --set prefill`` timed 7-15x slower (PERF.md).
TC_SM_BW_SHARES = 4
# CTAs of the stream body the model puts on one SM.  More resident CTAs
# fit (256 threads of about 90 registers each), but one per SM with longer
# K slices was as fast or faster at the decode shapes than two with
# shorter ones (``launch.sweep_gemm``, PERF.md): the fixed cost of a CTA
# (staging its rows, the slice reduction) is paid once per slice.
STREAM_CTAS_PER_SM = 1
# The grouped / ragged weight stream (a TMA ring, as the tensor-core body)
# gets the same TC_SM_BW_SHARES a CTA; cutting its K into slices costs it
# this share of its bandwidth.  Measured on the H100 (``launch.sweep_gemm``,
# PERF.md): one slice was the fastest at every shape swept -- the MoE pairs'
# 896 / 256 CTAs and qwen3-1.7b's dense pair, whose 48 one-slice CTAs took
# 21.8 us against 27.2 us at 2 slices (96 CTAs) and 29.0-43.3 us at 4-16.
GSTREAM_SLICED_BW = 0.8


def occupancy(ctas: int, spec: HopperSpec = H100) -> float:
    """Share of the SMs busy over the grid's waves (1.0 = full waves)."""
    waves = max(cdiv(ctas, spec.sms), 1)
    return ctas / (waves * spec.sms)


@dataclass(frozen=True)
class PlanEstimate:
    """Roofline-style estimate for one candidate tile."""
    flops_useful: float
    flops_padded: float
    hbm_bytes: float
    t_compute: float
    t_memory: float
    smem_bytes: int
    occupancy: float

    @property
    def t_total(self) -> float:
        # Loads are staged while the previous K step computes: take the max.
        return max(self.t_compute, self.t_memory)


def _estimate(g: int, m: int, k: int, n: int, *, bm: int, bn: int, bk: int,
              a_reads: int, b_reads: int, in_bytes: int, out_bytes: int,
              panels: int, spec: HopperSpec, body: str = "fma",
              stages: int = 4, dim_order: str = "mn",
              fp8: bool = False) -> PlanEstimate:
    gm, gn, gk = cdiv(m, bm), cdiv(n, bn), cdiv(k, bk)
    ctas = g * gm * gn
    occ = max(occupancy(ctas, spec), 1e-3)
    flops_useful = 2.0 * g * m * n * k * panels
    flops_padded = 2.0 * ctas * bm * bn * gk * bk * panels
    if body == "tc":
        # The grid walks the inner dimension of dim_order fastest (within
        # each group), so the outer operand's panel is reused from L2 by the
        # consecutive tiles and read once; the inner operand's panel is read
        # once too when it fits half the L2, else once per outer tile.
        a_once = a_reads * m * k * in_bytes
        b_once = b_reads * k * n * in_bytes * panels
        fits = spec.l2_bytes / 2
        if dim_order == "mn":
            hbm = a_once + b_once * (1 if k * n * in_bytes <= fits else gm)
        else:
            hbm = b_once + a_once * (1 if m * k * in_bytes <= fits else gn)
        hbm += g * m * n * out_bytes
    else:
        hbm = (a_reads * m * k * gn * in_bytes
               + b_reads * k * n * gm * in_bytes * panels
               + g * m * n * out_bytes)
    bw_share = min(occ * TC_SM_BW_SHARES, 1.0) if body == "tc" else occ
    return PlanEstimate(
        flops_useful=flops_useful,
        flops_padded=flops_padded,
        hbm_bytes=float(hbm),
        t_compute=flops_padded / (spec.kernel_flops(body, in_bytes, fp8)
                                  * occ),
        t_memory=hbm / (spec.hbm_bw * bw_share),
        smem_bytes=smem_bytes(bm, bn, bk, panels, body=body, stages=stages),
        occupancy=occ,
    )


def with_epilogue(e: PlanEstimate, m: int, n: int, out_bytes: int,
                  epi_ops: int, fused: bool,
                  spec: HopperSpec = H100) -> PlanEstimate:
    """``e`` with an elementwise tail of ``epi_ops`` ops: fused it rides
    the flush for free; unfused each op is a separate pass that reads and
    writes the (m, n) output once more, at the card's full bandwidth."""
    if fused or epi_ops <= 0:
        return e
    extra = float(epi_ops) * 2.0 * m * n * out_bytes
    return replace(e, hbm_bytes=e.hbm_bytes + extra,
                   t_memory=e.t_memory + extra / spec.hbm_bw)


def estimate(m: int, k: int, n: int, *, bm: int, bn: int, bk: int,
             in_bytes: int = 4, out_bytes: int = 4, panels: int = 1,
             spec: HopperSpec = H100, body: str = "fma",
             stages: int = 4, dim_order: str = "mn", epi_ops: int = 0,
             epi_fused: bool = True, fp8: bool = False) -> PlanEstimate:
    """Model one tile of C(M,N) = A(M,K) B(K,N) on one card.  ``panels`` = 2
    prices the fused SwiGLU pair (two B panels against one A panel);
    ``body`` "tc" the tensor-core body with a ``stages``-deep ring, whose
    operand traffic follows the grid order's L2 reuse; ``epi_ops`` an
    elementwise tail, fused or not (``with_epilogue``); ``fp8``: 1-byte
    operands are fp8, not int8 (``HopperSpec.kernel_flops``)."""
    e = _estimate(1, m, k, n, bm=bm, bn=bn, bk=bk, a_reads=1, b_reads=1,
                  in_bytes=in_bytes, out_bytes=out_bytes, panels=panels,
                  spec=spec, body=body, stages=stages, dim_order=dim_order,
                  fp8=fp8)
    return with_epilogue(e, m, n, out_bytes, epi_ops, epi_fused, spec)


def estimate_stream(m: int, k: int, n: int, *, kslices: int,
                    in_bytes: int = 2, out_bytes: int = 4,
                    spec: HopperSpec = H100) -> PlanEstimate:
    """Model the weight-stream body (M <= 16): one CTA per (STREAM_STRIP-wide
    N strip, K slice), STREAM_CTAS_PER_SM of them resident on an SM.  The
    weight is read once, and so is A: its at most 16 rows stay in the 50 MB
    L2 for the other strips.  With more than one slice each slice's fp32
    partial is written and read back once.  The FMAs run on the compiled
    row count, at the CUDA cores' rate."""
    rows = stream_rows(m)
    sl, slices = stream_slice(k, kslices)
    strips = cdiv(n, STREAM_STRIP)
    ctas = strips * slices
    # Its CTAs are short loops of loads: once the grid fills every slot the
    # card's bandwidth is saturated, and a last partial wave is only a tail.
    occ = max(min(ctas / (spec.sms * STREAM_CTAS_PER_SM), 1.0), 1e-3)
    flops_padded = 2.0 * ctas * rows * STREAM_STRIP * sl
    hbm = (k * n * in_bytes + m * k * in_bytes + m * n * out_bytes
           + (2 * slices * m * n * 4 if slices > 1 else 0))
    return PlanEstimate(
        flops_useful=2.0 * m * n * k,
        flops_padded=flops_padded,
        hbm_bytes=float(hbm),
        t_compute=flops_padded / (spec.kernel_flops("stream") * occ),
        t_memory=hbm / (spec.hbm_bw * occ),
        smem_bytes=smem_bytes(rows, STREAM_STRIP, sl, body="stream"),
        occupancy=occ,
    )


def estimate_group_stream(groups: int, rows: int, k: int, n: int, *,
                          kslices: int, in_bytes: int = 2,
                          out_bytes: int = 2, panels: int = 1,
                          spec: HopperSpec = H100) -> PlanEstimate:
    """Model the grouped / ragged weight stream: ``groups`` panels reached
    (k, n) each (``panels`` = 2: the SwiGLU pair reads a gate and an up
    panel of each), ``rows`` output rows in all (at most GSTREAM_ROWS a
    group).  One CTA per (STREAM_STRIP-wide N strip, K slice, reached
    group), STREAM_CTAS_PER_SM of them on an SM; every reached panel is
    read once, the rows' activations once (their re-reads by the other
    strips hit the L2), and with more than one slice each slice's fp32
    partials (one per panel) are written and read back once.  Each CTA
    draws up to TC_SM_BW_SHARES of the card's bandwidth, a grid cut into
    K slices GSTREAM_SLICED_BW of what it would draw uncut.  The math is
    wgmma at the tensor cores' rate on GSTREAM_ROWS token columns a
    group."""
    sl, slices = stream_slice(k, kslices)
    ctas = groups * cdiv(n, STREAM_STRIP) * slices
    occ = max(min(ctas / (spec.sms * STREAM_CTAS_PER_SM), 1.0), 1e-3)
    bw_share = (min(occ * TC_SM_BW_SHARES, 1.0)
                * (GSTREAM_SLICED_BW if slices > 1 else 1.0))
    flops_padded = 2.0 * ctas * GSTREAM_ROWS * STREAM_STRIP * sl * panels
    hbm = (groups * k * n * in_bytes * panels + rows * k * in_bytes
           + rows * n * out_bytes + (2 * slices * panels * rows * n * 4
                                     if slices > 1 else 0))
    return PlanEstimate(
        flops_useful=2.0 * rows * n * k * panels,
        flops_padded=flops_padded,
        hbm_bytes=float(hbm),
        t_compute=flops_padded / (spec.peak_flops_bf16 * occ),
        t_memory=hbm / (spec.hbm_bw * bw_share),
        smem_bytes=gstream_smem(panels),
        occupancy=occ,
    )


def estimate_batched(g: int, m: int, k: int, n: int, *, bm: int, bn: int,
                     bk: int, shared_a: bool = False, shared_b: bool = False,
                     in_bytes: int = 4, out_bytes: int = 4, panels: int = 1,
                     spec: HopperSpec = H100, body: str = "fma",
                     stages: int = 4, dim_order: str = "mn") -> PlanEstimate:
    """Model one tile of the grouped GEMM C(g) = A(g) B(g), g < G.  A shared
    2-D operand is read from device memory once and re-read by the other
    groups' CTAs from the 50 MB L2.  ``panels`` = 2 prices the grouped
    SwiGLU pair (two B panels per group, and their shared memory).
    ``body`` "tc" prices the tensor-core body with a ``stages``-deep ring,
    its operand traffic following the grid order's L2 reuse; the stream
    body has its own model (``estimate_group_stream``)."""
    return _estimate(g, m, k, n, bm=bm, bn=bn, bk=bk,
                     a_reads=1 if shared_a else g, b_reads=1 if shared_b else g,
                     in_bytes=in_bytes, out_bytes=out_bytes, panels=panels,
                     spec=spec, body=body, stages=stages,
                     dim_order=dim_order)


def estimate_ragged(g: int, total: int, k: int, n: int, *, bm: int, bn: int,
                    bk: int, ragged: str = "m", in_bytes: int = 4,
                    out_bytes: int = 4, panels: int = 1,
                    spec: HopperSpec = H100, body: str = "fma",
                    stages: int = 2, fp8: bool = False) -> PlanEstimate:
    """Model one tile of the ragged grouped GEMM over ``g`` groups.

    ``ragged == "m"`` (the forward): ``total`` rows of a flat (total, k)
    operand cut into groups against per-group (k, n) panels.  The per-group
    counts live on the device, so the price is the distribution's worst case
    for these totals: the rows in ``bm``-row chunks plus one partial chunk
    per group that has rows (at most min(g, total) groups do).  Each chunk's
    CTAs read their group's panel (``panels`` = 2 for the SwiGLU pair) once
    per N tile; x is read once per N tile; empty groups read nothing.

    ``ragged == "k"`` (the dW): the ragged rows are the contraction and
    each group owns a (k, n) output panel (``k`` = D, ``n`` = F).  The grid
    is (D tile x F tile, group): both row operands stream once per output
    tile of their group, the rows are walked in ``bk`` steps with one
    partial step per group, and each of the G panels is written once,
    empty ones too.  ``body`` "tc" prices either on the tensor-core body
    with a ``stages``-deep ring; the forward's stream body has its own
    model (``estimate_group_stream``).  ``fp8``: 1-byte operands are fp8,
    not int8 (``HopperSpec.kernel_flops``)."""
    if ragged == "k":
        gm, gn = cdiv(k, bm), cdiv(n, bn)
        steps = cdiv(total, bk) + max(min(g, total) - 1, 0)
        ctas = g * gm * gn
        occ = max(occupancy(ctas, spec), 1e-3)
        flops_padded = 2.0 * gm * bm * gn * bn * steps * bk
        hbm = (total * k * gn * in_bytes + total * n * gm * in_bytes
               + g * k * n * out_bytes)
        bw_share = min(occ * TC_SM_BW_SHARES, 1.0) if body == "tc" else occ
        return PlanEstimate(
            flops_useful=2.0 * total * k * n,
            flops_padded=flops_padded,
            hbm_bytes=float(hbm),
            t_compute=flops_padded / (spec.kernel_flops(body) * occ),
            t_memory=hbm / (spec.hbm_bw * bw_share),
            smem_bytes=smem_bytes(bm, bn, bk, body=body, stages=stages),
            occupancy=occ,
        )
    if ragged != "m":
        raise ValueError(f"unknown ragged axis: {ragged!r}")
    if body not in ("fma", "tc"):
        raise ValueError(f"estimate_ragged prices the fma and tc bodies, not "
                         f"{body!r} (estimate_group_stream)")
    gn, gk = cdiv(n, bn), cdiv(k, bk)
    chunks = cdiv(total, bm) + max(min(g, total) - 1, 0)
    ctas = gn * chunks
    occ = max(occupancy(ctas, spec), 1e-3)
    flops_padded = 2.0 * ctas * bm * bn * gk * bk * panels
    hbm = (total * k * gn * in_bytes + chunks * k * n * in_bytes * panels
           + total * n * out_bytes)
    bw_share = min(occ * TC_SM_BW_SHARES, 1.0) if body == "tc" else occ
    return PlanEstimate(
        flops_useful=2.0 * total * n * k * panels,
        flops_padded=flops_padded,
        hbm_bytes=float(hbm),
        t_compute=flops_padded / (spec.kernel_flops(body, in_bytes, fp8)
                                  * occ),
        t_memory=hbm / (spec.hbm_bw * bw_share),
        smem_bytes=smem_bytes(bm, bn, bk, panels, body=body, stages=stages),
        occupancy=occ,
    )


@dataclass(frozen=True)
class EpEstimate:
    """Modeled cost of ONE expert-parallel exchange leg over NVLink."""
    link_bytes: float       # global bytes crossing the links (all ranks)
    t_exchange: float       # seconds, set by the BOTTLENECK rank
    imbalance: float = 1.0  # max-rank rows / mean-rank rows

    def __add__(self, other: "EpEstimate") -> "EpEstimate":
        return EpEstimate(self.link_bytes + other.link_bytes,
                          self.t_exchange + other.t_exchange,
                          max(self.imbalance, other.imbalance))


EP_ZERO = EpEstimate(0.0, 0.0)


def estimate_ep(rows: int, width: int, num_shards: int, *,
                elt_bytes: int = 4, spec: HopperSpec = H100,
                max_shard_rows: int | None = None) -> EpEstimate:
    """Price one leg of the EP token exchange (the reference's
    ``estimate_ep``, over NVLink).  A (rows, width) token matrix is
    row-sharded over ``num_shards`` ranks, and each must send the
    (num_shards - 1) / num_shards share of its rows that route to experts
    other ranks own.  Bandwidth-bound, so t is one rank's send time over
    its links -- and, as the slowest participant sets the clock, that of
    the *max* rank: ``max_shard_rows`` (the largest rank's rows, when the
    distribution is known) scales it by max / mean; None assumes balance.
    One EP GEMM pays TWO legs (dispatch + return): add the estimates."""
    if num_shards <= 1:
        return EP_ZERO
    frac = (num_shards - 1) / num_shards
    link_bytes = float(rows) * width * elt_bytes * frac
    mean_rows = rows / num_shards
    imbalance = 1.0
    if max_shard_rows is not None and mean_rows > 0:
        imbalance = max(1.0, float(max_shard_rows) / mean_rows)
    bottleneck = (link_bytes / num_shards) * imbalance
    return EpEstimate(link_bytes, bottleneck / spec.link_bw, imbalance)
