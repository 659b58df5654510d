"""ftIMM GEMM planning and dispatch for the port: the shape taxonomy,
the Hopper CMR model, the tile and placement planner, the dispatch layer,
the mesh executors (``collective``, ``distributed``), and the measured
tuning loop (the plan store, ``autotune`` and calibration)."""
from . import autotune, collective, plan_store
from .autotune import (TuneResult, autotune_batched_gemm, autotune_gemm,
                       autotune_ragged_gemm, calibrate, calibrate_ici,
                       clear_plan_store, load_plan_cache, save_plan_cache,
                       time_placed_dense_e2e, time_placed_ragged_e2e)
from .cmr import (H100, EpEstimate, HopperSpec, PlanEstimate, estimate,
                  estimate_batched, estimate_ep, estimate_group_stream,
                  estimate_ragged, estimate_stream)
from .dispatch import (batched_matmul, grouped_matmul, grouped_swiglu, matmul,
                       matmul_swiglu, project, project_swiglu, ragged_matmul,
                       ragged_swiglu)
from .distributed import (dist_batched_matmul, dist_matmul, ep_ragged_matmul,
                          ep_ragged_moe, ep_ragged_swiglu)
from .plan_store import Calibration, PlanStore
from .shapes import GemmClass, classify, is_irregular
from .tuner import (DistPlan, GemmPlan, MoeDispatchPlan, Placement,
                    clear_plan_cache, effective_spec, epilogue_stats,
                    plan_batched_gemm, plan_distributed, plan_gemm,
                    plan_mode_stats, plan_moe_dispatch, plan_ragged_gemm,
                    preferred_ep_schedule)

__all__ = ["H100", "HopperSpec", "PlanEstimate", "estimate",
           "estimate_batched", "estimate_group_stream", "estimate_ragged",
           "estimate_stream", "matmul", "project", "matmul_swiglu",
           "project_swiglu", "batched_matmul", "grouped_matmul",
           "grouped_swiglu", "ragged_matmul", "ragged_swiglu", "GemmClass",
           "classify", "is_irregular", "GemmPlan", "MoeDispatchPlan",
           "plan_gemm", "plan_batched_gemm", "plan_ragged_gemm",
           "plan_moe_dispatch", "plan_mode_stats", "epilogue_stats",
           "effective_spec", "clear_plan_cache", "TuneResult",
           "autotune_gemm", "autotune_batched_gemm", "autotune_ragged_gemm",
           "calibrate", "calibrate_ici", "clear_plan_store",
           "load_plan_cache", "save_plan_cache", "time_placed_dense_e2e",
           "time_placed_ragged_e2e", "Calibration", "PlanStore",
           "EpEstimate", "estimate_ep", "dist_matmul", "dist_batched_matmul",
           "ep_ragged_matmul", "ep_ragged_swiglu", "ep_ragged_moe",
           "DistPlan", "Placement", "plan_distributed",
           "preferred_ep_schedule"]
