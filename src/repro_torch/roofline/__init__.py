"""The roofline of a step on H100s: ``perf_model`` counts a step's FLOPs
and device-memory bytes, ``analysis`` turns them and a rank's recorded
collectives into the compute, memory and collective terms, and
``dissect`` lists the largest collectives of a dry-run step."""
from .analysis import (Roofline, build_roofline, collective_bytes,
                       model_flops_estimate)
from .perf_model import forward_perf, step_perf

__all__ = ["Roofline", "build_roofline", "collective_bytes",
           "model_flops_estimate", "forward_perf", "step_perf"]
