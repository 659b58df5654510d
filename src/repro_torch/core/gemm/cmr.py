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

The estimate only ranks tiles; it is not a claim about the card's speed.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...kernels.ftimm.kernel import smem_bytes


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
    peak_flops_bf16: float = 989e12        # tensor cores
    peak_flops_fp32: float = 67e12         # CUDA cores, FMA

    def kernel_flops(self) -> float:
        """Peak of the engine the port's kernels use: every operand type is
        widened to fp32 and multiplied with FMAs on the CUDA cores (tensor
        core MMA is later work)."""
        return self.peak_flops_fp32


H100 = HopperSpec()


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
              panels: int, spec: HopperSpec) -> PlanEstimate:
    gm, gn, gk = cdiv(m, bm), cdiv(n, bn), cdiv(k, bk)
    ctas = g * gm * gn
    occ = max(occupancy(ctas, spec), 1e-3)
    flops_useful = 2.0 * g * m * n * k * panels
    flops_padded = 2.0 * ctas * bm * bn * gk * bk * panels
    hbm = (a_reads * m * k * gn * in_bytes
           + b_reads * k * n * gm * in_bytes * panels
           + g * m * n * out_bytes)
    return PlanEstimate(
        flops_useful=flops_useful,
        flops_padded=flops_padded,
        hbm_bytes=float(hbm),
        t_compute=flops_padded / (spec.kernel_flops() * occ),
        t_memory=hbm / (spec.hbm_bw * occ),
        smem_bytes=smem_bytes(bm, bn, bk, panels),
        occupancy=occ,
    )


def estimate(m: int, k: int, n: int, *, bm: int, bn: int, bk: int,
             in_bytes: int = 4, out_bytes: int = 4, panels: int = 1,
             spec: HopperSpec = H100) -> PlanEstimate:
    """Model one tile of C(M,N) = A(M,K) B(K,N) on one card.  ``panels`` = 2
    prices the fused SwiGLU pair (two B panels against one A panel)."""
    return _estimate(1, m, k, n, bm=bm, bn=bn, bk=bk, a_reads=1, b_reads=1,
                     in_bytes=in_bytes, out_bytes=out_bytes, panels=panels,
                     spec=spec)


def estimate_batched(g: int, m: int, k: int, n: int, *, bm: int, bn: int,
                     bk: int, shared_a: bool = False, shared_b: bool = False,
                     in_bytes: int = 4, out_bytes: int = 4, panels: int = 1,
                     spec: HopperSpec = H100) -> PlanEstimate:
    """Model one tile of the grouped GEMM C(g) = A(g) B(g), g < G.  A shared
    2-D operand is read from device memory once and re-read by the other
    groups' CTAs from the 50 MB L2.  ``panels`` = 2 prices the grouped
    SwiGLU pair (two B panels per group, and their shared memory)."""
    return _estimate(g, m, k, n, bm=bm, bn=bn, bk=bk,
                     a_reads=1 if shared_a else g, b_reads=1 if shared_b else g,
                     in_bytes=in_bytes, out_bytes=out_bytes, panels=panels,
                     spec=spec)


def estimate_ragged(g: int, total: int, k: int, n: int, *, bm: int, bn: int,
                    bk: int, ragged: str = "m", in_bytes: int = 4,
                    out_bytes: int = 4, panels: int = 1,
                    spec: HopperSpec = H100) -> PlanEstimate:
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
    empty ones too."""
    if ragged == "k":
        gm, gn = cdiv(k, bm), cdiv(n, bn)
        steps = cdiv(total, bk) + max(min(g, total) - 1, 0)
        ctas = g * gm * gn
        occ = max(occupancy(ctas, spec), 1e-3)
        flops_padded = 2.0 * gm * bm * gn * bn * steps * bk
        hbm = (total * k * gn * in_bytes + total * n * gm * in_bytes
               + g * k * n * out_bytes)
        return PlanEstimate(
            flops_useful=2.0 * total * k * n,
            flops_padded=flops_padded,
            hbm_bytes=float(hbm),
            t_compute=flops_padded / (spec.kernel_flops() * occ),
            t_memory=hbm / (spec.hbm_bw * occ),
            smem_bytes=smem_bytes(bm, bn, bk),
            occupancy=occ,
        )
    if ragged != "m":
        raise ValueError(f"unknown ragged axis: {ragged!r}")
    gn, gk = cdiv(n, bn), cdiv(k, bk)
    chunks = cdiv(total, bm) + max(min(g, total) - 1, 0)
    ctas = gn * chunks
    occ = max(occupancy(ctas, spec), 1e-3)
    flops_padded = 2.0 * ctas * bm * bn * gk * bk * panels
    hbm = (total * k * gn * in_bytes + chunks * k * n * in_bytes * panels
           + total * n * out_bytes)
    return PlanEstimate(
        flops_useful=2.0 * total * n * k * panels,
        flops_padded=flops_padded,
        hbm_bytes=float(hbm),
        t_compute=flops_padded / (spec.kernel_flops() * occ),
        t_memory=hbm / (spec.hbm_bw * occ),
        smem_bytes=smem_bytes(bm, bn, bk, panels),
        occupancy=occ,
    )
