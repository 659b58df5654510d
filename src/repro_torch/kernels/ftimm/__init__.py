"""ftIMM GEMM kernels for Hopper (CUDA C++ in ``csrc/``) and their wrappers."""
from .epilogue import IDENTITY, Epilogue
from .kernel import launch_counts, reset_launch_counts
from .ops import batched_gemm, bench, gemm, gemm_swiglu

__all__ = ["Epilogue", "IDENTITY", "gemm", "gemm_swiglu", "batched_gemm",
           "bench", "launch_counts", "reset_launch_counts"]
