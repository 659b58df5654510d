"""ftIMM GEMM planning and dispatch for the port: the shape taxonomy,
the Hopper CMR model, the tile planner and the forward dispatch layer."""
from .cmr import H100, HopperSpec, PlanEstimate, estimate, estimate_batched
from .dispatch import (batched_matmul, matmul, matmul_swiglu, project,
                       project_swiglu)
from .shapes import GemmClass, classify, is_irregular
from .tuner import (GemmPlan, clear_plan_cache, epilogue_stats, plan_batched_gemm,
                    plan_gemm, plan_mode_stats)

__all__ = ["H100", "HopperSpec", "PlanEstimate", "estimate", "estimate_batched",
           "matmul", "project", "matmul_swiglu", "project_swiglu",
           "batched_matmul", "GemmClass", "classify", "is_irregular",
           "GemmPlan", "plan_gemm", "plan_batched_gemm", "plan_mode_stats",
           "epilogue_stats", "clear_plan_cache"]
