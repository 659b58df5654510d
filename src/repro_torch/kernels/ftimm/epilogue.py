"""The fused-epilogue spec shared by every GEMM engine.

A leaf module (imports nothing from the package), so the kernel layer, the
ops wrappers and the dispatch layer can all import it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

_ACTIVATIONS = ("none", "silu", "gelu")


@dataclass(frozen=True)
class Epilogue:
    """What to fuse into the accumulator flush of a GEMM.

    Applied to the fp32 accumulator before the output cast, in this order:

        y = act(acc * scale_vec * scale + bias) + residual

    ``bias`` / ``residual`` / ``scale_vec`` are flags; the operands ride
    along as extra kernel inputs (bias and scale_vec are (N,)-wide vectors
    broadcast over rows, residual shaped like the output).  ``scale_vec`` is
    the quantized paths' dequant vector, ``scale`` a static scalar.
    Hashable, so it can key caches."""
    bias: bool = False
    activation: str = "none"        # none | silu | gelu
    residual: bool = False
    scale: float | None = None
    scale_vec: bool = False

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(
                f"unknown epilogue activation: {self.activation!r} "
                f"(expected one of {_ACTIVATIONS})")

    @property
    def is_identity(self) -> bool:
        return (not self.bias and not self.residual and not self.scale_vec
                and self.activation == "none" and self.scale is None)

    @property
    def num_ops(self) -> int:
        """How many separate elementwise passes over the output the unfused
        tail runs: what fusing it into the flush saves."""
        return (int(self.scale_vec) + int(self.scale is not None)
                + int(self.bias) + int(self.activation != "none")
                + int(self.residual))

    def unpack(self, extras):
        """(bias, residual, scale) from a positional ``extras`` tuple that
        holds, in this order, the operands whose flags are set."""
        i = 0
        bias = residual = scale = None
        if self.bias:
            bias = extras[i]
            i += 1
        if self.residual:
            residual = extras[i]
            i += 1
        if self.scale_vec:
            scale = extras[i]
        return bias, residual, scale

    def decompose(self) -> tuple["Epilogue", ...]:
        """The tail as single-op epilogues in the order ``apply`` runs them:
        the unfused path's separate passes.  Applied one after another they
        give ``apply``."""
        ops = []
        if self.scale_vec:
            ops.append(Epilogue(scale_vec=True))
        if self.scale is not None:
            ops.append(Epilogue(scale=self.scale))
        if self.bias:
            ops.append(Epilogue(bias=True))
        if self.activation != "none":
            ops.append(Epilogue(activation=self.activation))
        if self.residual:
            ops.append(Epilogue(residual=True))
        return tuple(ops)

    def apply(self, acc: torch.Tensor, bias=None, residual=None,
              scale=None) -> torch.Tensor:
        """fp32 in / fp32 out: the one definition of the tail's math, used
        by every plain version.  ``scale`` is the runtime (N,)-wide dequant
        vector (``scale_vec``); it multiplies the raw accumulator first."""
        if self.scale_vec:
            acc = acc * scale.to(torch.float32)
        if self.scale is not None:
            acc = acc * self.scale
        if self.bias:
            acc = acc + bias.to(torch.float32)
        if self.activation == "silu":
            acc = acc * torch.sigmoid(acc)
        elif self.activation == "gelu":
            # jax.nn.gelu defaults to the tanh approximation; torch's to erf.
            acc = F.gelu(acc, approximate="tanh")
        if self.residual:
            acc = acc + residual.to(torch.float32)
        return acc


IDENTITY = Epilogue()
