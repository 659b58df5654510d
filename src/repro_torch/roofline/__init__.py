"""The analytic roofline of a step on one H100: ``perf_model`` counts a
step's FLOPs and device-memory bytes, ``analysis`` turns them into the
compute and memory terms."""
from .analysis import Roofline, build_roofline, model_flops_estimate
from .perf_model import forward_perf, step_perf

__all__ = ["Roofline", "build_roofline", "model_flops_estimate",
           "forward_perf", "step_perf"]
