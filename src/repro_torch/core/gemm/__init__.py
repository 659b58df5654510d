"""ftIMM GEMM planning and dispatch for the port: the shape taxonomy,
the Hopper CMR model (with the paper's Eqs. 1-4 and its per-shape
utilization bound), the tile and placement planner (with the TGEMM
baseline), the dispatch layer, the mesh executors (``collective``,
``distributed``), and the measured tuning loop (the plan store,
``autotune`` and calibration)."""
from ...kernels.ftimm.epilogue import Epilogue
from ..quant import QuantConfig
from . import autotune, collective, plan_store
from .autotune import (TuneResult, autotune_batched_gemm, autotune_gemm,
                       autotune_ragged_gemm, calibrate, calibrate_ici,
                       clear_plan_store, load_plan_cache, save_plan_cache,
                       time_placed_dense_e2e, time_placed_ragged_e2e)
from .cmr import (H100, EpEstimate, HopperSpec, PlanEstimate, estimate,
                  estimate_batched, estimate_ep, estimate_group_stream,
                  estimate_ragged, estimate_rows, estimate_stream,
                  upper_bound_fraction)
from .dispatch import (batched_matmul, grouped_matmul, grouped_swiglu, matmul,
                       matmul_swiglu, project, project_swiglu, ragged_matmul,
                       ragged_swiglu)
from .distributed import (choose_strategy, dist_batched_matmul, dist_matmul,
                          ep_ragged_matmul, ep_ragged_moe, ep_ragged_swiglu)
from .plan_store import Calibration, PlanStore
from .shapes import GemmClass, ShapeThresholds, classify, is_irregular
from .tuner import (DistPlan, GemmPlan, MoeDispatchPlan, Placement,
                    clear_plan_cache, degraded_stats, effective_spec,
                    epilogue_stats, plan_batched_gemm, plan_distributed,
                    plan_gemm, plan_mode_stats, plan_moe_dispatch,
                    plan_ragged_gemm, preferred_ep_schedule, tgemm_plan)

__all__ = ["H100", "HopperSpec", "PlanEstimate", "estimate",
           "estimate_batched", "estimate_group_stream", "estimate_ragged",
           "estimate_rows",
           "estimate_stream", "upper_bound_fraction", "Epilogue",
           "QuantConfig", "ShapeThresholds", "degraded_stats", "tgemm_plan",
           "choose_strategy", "matmul", "project", "matmul_swiglu",
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
