"""ftIMM GEMM planning and dispatch for the port: the shape taxonomy,
the Hopper CMR model, the tile planner and the forward dispatch layer."""
from .cmr import (H100, HopperSpec, PlanEstimate, estimate, estimate_batched,
                  estimate_group_stream, estimate_ragged, estimate_stream)
from .dispatch import (batched_matmul, grouped_matmul, grouped_swiglu, matmul,
                       matmul_swiglu, project, project_swiglu, ragged_matmul,
                       ragged_swiglu)
from .shapes import GemmClass, classify, is_irregular
from .tuner import (GemmPlan, MoeDispatchPlan, clear_plan_cache,
                    epilogue_stats, plan_batched_gemm, plan_gemm,
                    plan_mode_stats, plan_moe_dispatch, plan_ragged_gemm)

__all__ = ["H100", "HopperSpec", "PlanEstimate", "estimate", "estimate_batched",
           "estimate_group_stream", "estimate_ragged", "estimate_stream", "matmul", "project", "matmul_swiglu",
           "project_swiglu", "batched_matmul", "grouped_matmul",
           "grouped_swiglu", "ragged_matmul", "ragged_swiglu", "GemmClass",
           "classify", "is_irregular", "GemmPlan", "MoeDispatchPlan",
           "plan_gemm", "plan_batched_gemm", "plan_ragged_gemm",
           "plan_moe_dispatch", "plan_mode_stats", "epilogue_stats",
           "clear_plan_cache"]
