"""Error-feedback int8 gradient compression for the data-parallel
all-reduce, over a process group.

Each rank quantizes its gradient (plus the error it carried from the last
step) to int8 against a scale every rank shares -- the global max|g| from
one scalar all-reduce MAX -- sums the int8 codes over the axis (1 byte an
element on the wire, a quarter of fp32's) and keeps what the rounding
dropped for the next step (error feedback, which keeps the scheme
convergent).  Each rank clips its codes to +-(127 // n), so the sum over n
ranks cannot wrap.  The rounding is ``core.quant``'s, the one rule the
quantized GEMM paths use (the reference's ``optim/compression.py``).

As in the reference, the trainer does not call it: it is a building block
for a data-parallel step that syncs its gradients itself.  Under the host
transport (gloo) with CUDA tensors the staged buffers are the int8 codes
and the fp32 max (``collective.counts()``).
"""
from __future__ import annotations

import torch

from ..core.gemm import collective
from ..core.quant import (INT8_LEVELS, dequantize, error_residual, quantize,
                          scale_from_absmax)

F32 = torch.float32


def compress_allreduce(g: torch.Tensor, err: torch.Tensor, mesh, axis,
                       num_devices: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce-mean one gradient tensor over ``mesh[axis]`` in int8 with
    error feedback; every rank of the axis calls it.  ``num_devices``:
    the axis size (default: read from the mesh).  -> (the mean gradient,
    fp32; this rank's new error, fp32)."""
    n = mesh.axis_size(axis) if num_devices is None else num_devices
    gf = g.to(F32) + err
    local_max = gf.abs().amax().reshape(1)
    global_max = collective.raw_all_reduce(local_max, mesh, axis, "max")[0]
    level = max(INT8_LEVELS // max(n, 1), 1)
    scale = scale_from_absmax(global_max, level)
    q = quantize(gf, scale, level)                    # int8
    new_err = error_residual(gf, q, scale)
    q_sum = collective.raw_all_reduce(q, mesh, axis)  # int8 on the wire
    return dequantize(q_sum, scale) / n, new_err


def init_error_state(params: dict) -> dict:
    """A zero fp32 error for each tensor of ``params`` (a dict)."""
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}
