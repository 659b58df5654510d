"""Plain PyTorch oracles for the ftIMM GEMM kernels.

The ground truth the CUDA kernels in ``csrc/`` are held to, and the engine
the kernel wrappers use for tensors on the CPU.  C = op(A) x op(B) with fp32
accumulation; the result is cast to ``out_dtype``.
"""
from __future__ import annotations

import torch


def _f32_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(out_dtype)


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
