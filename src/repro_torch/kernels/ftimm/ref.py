"""Plain PyTorch oracles for the ftIMM GEMM kernels.

The ground truth the CUDA kernels in ``csrc/`` are held to, and the engine
the kernel wrappers use for tensors on the CPU.  C = op(A) x op(B); the
result is cast to ``out_dtype``.

The dtype axis is the reference's (``_acc_dtype`` / ``_dot_operands``):
int x int sums exactly, as the reference's int32 accumulator does (here in
float64, where every partial sum of int8 products is an integer far below
2^53, so the sum is exact in any order and runs on the CPU and the card
alike), then becomes fp32; every other pair (float x int, fp8, bf16, fp32)
is widened to fp32 and summed in fp32.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def acc_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions sum ``a_dtype`` x ``b_dtype`` in:
    float64 (exact) for two integer types, else fp32."""
    ints = [not (d.is_floating_point or d.is_complex)
            for d in (a_dtype, b_dtype)]
    return torch.float64 if all(ints) else F32


def _f32_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    acc = acc_dtype(a.dtype, b.dtype)
    out = torch.matmul(a.to(acc), b.to(acc))
    return out.to(F32).to(out_dtype)


def matmul_nn(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B with A:(M,K), B:(K,N) -> (M,N); fp32 accumulation."""
    return _f32_matmul(a, b, out_dtype or a.dtype)


def matmul_tn(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A.T @ B with A:(K,M), B:(K,N) -> (M,N); the paper's T2 layout."""
    return _f32_matmul(a.transpose(-1, -2), b, out_dtype or a.dtype)


def matmul_nt(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B.T with A:(M,K), B:(N,K) -> (M,N)."""
    return _f32_matmul(a, b.transpose(-1, -2), out_dtype or a.dtype)


REF = {"nn": matmul_nn, "tn": matmul_tn, "nt": matmul_nt}


def ragged_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      group_offsets: torch.Tensor, trans: str = "nn",
                      out_dtype=None) -> torch.Tensor:
    """Dense oracle for the ragged grouped GEMM: one masked full-width GEMM
    per group, summed as ``acc_dtype`` says.  x (T, K), w (G, K, N) "nn" | (G, N, K)
    "nt", ``group_offsets`` (G+1,) prefix sums (read on the device, never
    on the host).  Rows outside every group (offsets[G] < T) yield zeros."""
    out_dtype = out_dtype or x.dtype
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    n = w.shape[2] if trans == "nn" else w.shape[1]
    dt = acc_dtype(x.dtype, w.dtype)
    xf = x.to(dt)
    acc = torch.zeros((x.shape[0], n), dtype=dt, device=x.device)
    for g in range(w.shape[0]):
        mask = (rows >= group_offsets[g]) & (rows < group_offsets[g + 1])
        wg = w[g].to(dt)
        acc = acc + torch.where(mask, xf, 0.0) @ (wg if trans == "nn" else wg.T)
    return acc.to(F32).to(out_dtype)


def ragged_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                         group_offsets: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """Dense oracle for the ragged T2 backward: per-group x^T @ dy with the
    rows outside the group masked to zero -> (G, D, F).  An empty group
    gives a zero panel; rows outside every group enter no panel."""
    out_dtype = out_dtype or x.dtype
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    xf, dyf = x.to(torch.float32), dy.to(torch.float32)
    panels = []
    for g in range(group_offsets.shape[0] - 1):
        mask = (rows >= group_offsets[g]) & (rows < group_offsets[g + 1])
        panels.append(torch.where(mask, xf, 0.0).T @ dyf)
    return torch.stack(panels).to(out_dtype)


def ragged_swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, group_offsets: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """Oracle for the fused ragged SwiGLU pair: silu(x@Wg_g) * (x@Wu_g)."""
    a = ragged_matmul_ref(x, w_gate, group_offsets, out_dtype=torch.float32)
    b = ragged_matmul_ref(x, w_up, group_offsets, out_dtype=torch.float32)
    return (a * torch.sigmoid(a) * b).to(out_dtype or x.dtype)


def k_per_split(k: int, bk: int, nsplit: int) -> int:
    """K extent of one split of the K-parallel kernel: cdiv(cdiv(K, bk),
    nsplit) blocks of ``bk``."""
    return -(-(-(-k // bk)) // nsplit) * bk


def matmul_splitk(a: torch.Tensor, b: torch.Tensor, nsplit: int, *,
                  bk: int, trans: str = "nn", out_dtype=None) -> torch.Tensor:
    """Oracle for the K-parallel strategy (paper Alg. 5): fp32 partial
    products over K slices, summed in split order at the end.  The K split
    is the kernel's (``k_per_split``), so K need not divide evenly (a split
    past the end contributes zeros)."""
    out_dtype = out_dtype or a.dtype
    a_ = a.transpose(-1, -2) if trans == "tn" else a        # (M, K)
    b_ = b.transpose(-1, -2) if trans == "nt" else b        # (K, N)
    k = a_.shape[1]
    per = k_per_split(k, bk, nsplit)
    partials = torch.zeros((nsplit, a_.shape[0], b_.shape[1]),
                           dtype=torch.float32, device=a.device)
    for s in range(nsplit):
        lo, hi = min(s * per, k), min((s + 1) * per, k)
        partials[s] = a_[:, lo:hi].to(torch.float32) @ b_[lo:hi].to(
            torch.float32)
    return partials.sum(dim=0).to(out_dtype)
