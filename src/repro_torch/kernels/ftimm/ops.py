"""Public wrappers around the ftIMM kernels: ``gemm`` (M-parallel, or
K-parallel with ``nsplit > 1``; ``gemm_unfused``: its epilogue as separate
passes), ``gemm_swiglu``, ``batched_gemm``,
``batched_gemm_swiglu``, ``ragged_gemm``, ``ragged_gemm_swiglu``,
``ragged_gemm_dw`` and the timing primitive ``bench``.

Edges are always masked in-kernel: unpadded operands go straight to the
kernels and the output comes back unsliced, so no pad or slice copy ever
touches device memory.  For the FMA body, requested blocks are clamped to
the problem extent and mapped onto the compiled tile menu
(``kernel.TILES``); each compiled tile carries its own K step, so ``bk``
follows the tile.  The tensor-core body takes a tile of
``kernel.TC_TILES`` (the grouped and ragged kernels: ``GROUP_TC_TILE``)
as it is (TMA fills the edges), and a stream body its K slice count.  The
ragged
wrappers pass the device prefix sums straight to the kernels, which find
each group's rows themselves: the TPU path's host-built visit list
(``_ragged_metadata``) has no counterpart here.
"""
from __future__ import annotations

import time

import torch

from . import kernel as _k
from .epilogue import Epilogue


def _ceil_to(x: int, b: int) -> int:
    return (x + b - 1) // b * b


def clamp_tile(m: int, n: int, bm: int, bn: int) -> tuple[int, int, int]:
    """The largest compiled tile within the requested blocks, after the
    blocks are clamped to the (rounded) problem extent: a 4-row GEMM under a
    128-row request runs the 16-row tile instead of masking 124 rows."""
    bm_ = min(bm, _ceil_to(max(m, 1), 16))
    bn_ = min(bn, _ceil_to(max(n, 1), 32))
    for tile in reversed(_k.TILES):
        if tile[0] <= bm_ and tile[1] <= bn_:
            return tile
    return _k.TILES[0]


def clamp_nsplit(k: int, bk: int, nsplit: int) -> int:
    """The split count ``gemm`` runs: at most one split per K block of the
    tile (the tensor-core body's: its bk of 64), at least 1 (the
    M-parallel kernel)."""
    return max(1, min(nsplit, -(-k // bk)))


def bench(fn, *args, warmup: int = 1, repeats: int = 3) -> float:
    """Median seconds of one ``fn(*args)``.  When an argument lies on a
    CUDA device each repeat is timed with CUDA events around the call (the
    device's time, not the enqueue); otherwise with the host clock."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(max(warmup, 1)):
        fn(*args)
    ts = []
    for _ in range(max(repeats, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
         bk: int = 16, nsplit: int = 1, trans: str = "nn",
         dim_order: str = "mn", out_dtype=None,
         epilogue: Epilogue | None = None, bias=None, residual=None,
         scale=None, body: str = "fma", kslices: int = 1) -> torch.Tensor:
    """Dense ftIMM GEMM with the epilogue fused at the flush.  ``scale`` is
    the (N,) dequant vector when ``epilogue.scale_vec``.  ``body`` picks
    the FMA, tensor-core or stream body of ``ftimm_gemm`` (the stream body
    cuts K into ``kslices`` slices).  ``nsplit > 1`` selects the split-K
    kernel on the FMA or tensor-core ``body`` (the epilogue then runs on
    the fp32 sum of the partials; the stream body splits K its own way and
    raises); the split count is clamped to the K blocks of the body's tile,
    and degenerates to 1, the M-parallel kernel."""
    if dim_order not in ("mn", "nm"):
        raise ValueError(f"unknown dim_order: {dim_order!r}")
    if body == "stream" and nsplit > 1:
        raise ValueError(f"nsplit {nsplit} runs the split-K kernel, which "
                         "has no stream body (the stream splits K into "
                         "kslices)")
    m, k, n = _k.mkn(trans, a.shape, b.shape)
    if body == "fma":
        bm, bn, bk = clamp_tile(m, n, bm, bn)
    nsplit = clamp_nsplit(k, bk, nsplit)
    epilogue = epilogue or _k.IDENTITY
    if nsplit > 1:
        return _k.ftimm_gemm_splitk(
            a, b, bm=bm, bn=bn, bk=bk, nsplit=nsplit, trans=trans,
            dim_order=dim_order, out_dtype=out_dtype, epilogue=epilogue,
            bias=bias, residual=residual, scale=scale, body=body)
    return _k.ftimm_gemm(a, b, bm=bm, bn=bn, bk=bk, trans=trans,
                         dim_order=dim_order, out_dtype=out_dtype,
                         epilogue=epilogue, bias=bias, residual=residual,
                         scale=scale, body=body, kslices=kslices)


def gemm_unfused(a: torch.Tensor, b: torch.Tensor, *, epilogue: Epilogue,
                 out_dtype=None, bias=None, residual=None, scale=None,
                 **kw) -> torch.Tensor:
    """``gemm`` with the epilogue not fused: the identity kernel to fp32
    (``kw``: its trans, tile, body, ...), then the tail one op at a time
    (``Epilogue.decompose``), a separate pass over the output each, then
    the cast."""
    z = gemm(a, b, out_dtype=torch.float32, **kw)
    for op in epilogue.decompose():
        z = op.apply(z, bias=bias, residual=residual, scale=scale)
    return z.to(out_dtype or a.dtype)


def batched_gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 16, trans: str = "nn",
                 dim_order: str = "mn", out_dtype=None,
                 epilogue: Epilogue | None = None, bias=None, residual=None,
                 scale=None, body: str = "fma",
                 kslices: int = 1) -> torch.Tensor:
    """Batched / grouped entry.  Either operand may be 2-D (shared across
    the batch); ``bias`` and ``scale`` are (N,) shared or (G, N) per group,
    ``residual`` (G, M, N).  ``body`` picks the FMA, tensor-core or stream
    body of ``ftimm_gemm_grouped`` (the stream cuts K into ``kslices``)."""
    if dim_order not in ("mn", "nm"):
        raise ValueError(f"unknown dim_order: {dim_order!r}")
    if body == "fma":
        m, _, n = _k.mkn(trans, a.shape[-2:], b.shape[-2:])
        bm, bn, bk = clamp_tile(m, n, bm, bn)
    return _k.ftimm_gemm_grouped(a, b, bm=bm, bn=bn, bk=bk, trans=trans,
                                 dim_order=dim_order, out_dtype=out_dtype,
                                 epilogue=epilogue or _k.IDENTITY, bias=bias,
                                 residual=residual, scale=scale, body=body,
                                 kslices=kslices)


def gemm_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                *, bm: int = 128, bn: int = 128, bk: int = 16,
                out_dtype=None, body: str = "fma", kslices: int = 1,
                dim_order: str = "mn") -> torch.Tensor:
    """Dense fused SwiGLU pair: silu(x @ Wg) * (x @ Wu) in one launch.
    ``body`` picks the FMA, tensor-core or stream body of
    ``ftimm_gemm_swiglu`` (the stream cuts K into ``kslices``)."""
    if body == "fma":
        bm, bn, bk = clamp_tile(x.shape[0], w_gate.shape[1], bm, bn)
    return _k.ftimm_gemm_swiglu(x, w_gate, w_up, bm=bm, bn=bn, bk=bk,
                                out_dtype=out_dtype, body=body,
                                kslices=kslices, dim_order=dim_order)


def batched_gemm_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, *, bm: int = 128, bn: int = 128,
                        bk: int = 16, out_dtype=None, body: str = "fma",
                        kslices: int = 1) -> torch.Tensor:
    """Grouped fused SwiGLU pair -- the capacity-mode MoE gate/up projections
    (E, C, D) @ 2 x (E, D, F) in one launch.  ``x`` may be (M, K), shared
    by every group.  ``body`` as for ``batched_gemm``."""
    if body == "fma":
        bm, bn, bk = clamp_tile(x.shape[-2], w_gate.shape[-1], bm, bn)
    return _k.ftimm_gemm_grouped_swiglu(x, w_gate, w_up, bm=bm, bn=bn, bk=bk,
                                        out_dtype=out_dtype, body=body,
                                        kslices=kslices)


def ragged_gemm(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor,
                *, bm: int = 128, bn: int = 128, bk: int = 16,
                trans: str = "nn", out_dtype=None,
                epilogue: Epilogue | None = None, bias=None,
                scale=None, body: str = "fma",
                kslices: int = 1) -> torch.Tensor:
    """Capacity-free grouped GEMM: y[o_g:o_{g+1}] = x[o_g:o_{g+1}] @ W_g.
    ``w`` (G, K, N) "nn" | (G, N, K) "nt"; ``group_offsets`` (G+1,) prefix
    sums on the operands' device; ``bias`` / ``scale`` per-group (G, N)
    vectors applied at the flush.  ``body`` as for ``batched_gemm``."""
    if body == "fma":
        n = w.shape[2] if trans == "nn" else w.shape[1]
        bm, bn, bk = clamp_tile(x.shape[0], n, bm, bn)
    return _k.ftimm_gemm_ragged(x, w, group_offsets, bm=bm, bn=bn, bk=bk,
                                trans=trans, out_dtype=out_dtype,
                                epilogue=epilogue or _k.IDENTITY, bias=bias,
                                scale=scale, body=body, kslices=kslices)


def ragged_gemm_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, group_offsets: torch.Tensor, *,
                       bm: int = 128, bn: int = 128, bk: int = 16,
                       out_dtype=None, body: str = "fma",
                       kslices: int = 1) -> torch.Tensor:
    """Fused ragged pair: silu(x @ Wg_g) * (x @ Wu_g) per group, one launch
    (same contract as ``ragged_gemm``, ``body`` too)."""
    if body == "fma":
        bm, bn, bk = clamp_tile(x.shape[0], w_gate.shape[2], bm, bn)
    return _k.ftimm_gemm_ragged_swiglu(x, w_gate, w_up, group_offsets, bm=bm,
                                       bn=bn, bk=bk, out_dtype=out_dtype,
                                       body=body, kslices=kslices)


def ragged_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                   group_offsets: torch.Tensor, *, bm: int = 128,
                   bn: int = 128, bk: int = 16, out_dtype=None,
                   body: str = "fma") -> torch.Tensor:
    """Ragged T2 grouped GEMM: dW[g] = x[rows_g].T @ dy[rows_g] -> (G, D, F).
    ``bm`` / ``bn`` tile the per-group (D, F) panel; the contraction runs
    over each group's rows.  Same offsets contract as ``ragged_gemm``;
    empty groups yield zero panels, and T = 0 gives all-zero panels.
    ``body`` "tc" takes a tile of ``kernel.TC_TILES`` as it is."""
    g = group_offsets.shape[0] - 1
    out_dtype = out_dtype or x.dtype
    if x.shape[0] == 0:
        return torch.zeros((g, x.shape[1], dy.shape[1]), dtype=out_dtype,
                           device=x.device)
    if body == "fma":
        bm, bn, bk = clamp_tile(x.shape[1], dy.shape[1], bm, bn)
    return _k.ftimm_gemm_ragged_dw(x, dy, group_offsets, bm=bm, bn=bn, bk=bk,
                                   out_dtype=out_dtype, body=body)
