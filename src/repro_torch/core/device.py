"""Where the port runs: the CUDA card unless the caller asks for the CPU.

The entry points (``models.model.init_params``, ``serve.engine.ServeEngine``,
``launch.serve``) resolve their ``device`` argument here.  With no device
given they take the current CUDA device, and raise when there is none: the
port never drops to the CPU on its own.  ``device="cpu"`` is an explicit
request, and on the CPU every kernel wrapper runs its plain version.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on an NVIDIA GPU; pass "
                "device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def module_device(module: torch.nn.Module) -> torch.device:
    """The device of a module's first parameter."""
    return next(module.parameters()).device
