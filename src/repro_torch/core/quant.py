"""Quantization helpers of the port: one rounding rule for every consumer.

The port's own copy of the reference's ``core/quant.py``, with the same
arithmetic, so that every scale and every quantized value is bitwise the
reference's: divide in fp32, round half to even (``torch.round``, as
``jnp.round``), clip, cast.  The low-precision GEMMs use it for
per-tensor activation scales, per-channel (and per-expert) weight scales,
int4 nibble packing and fp8 casts.

Conventions:

  * Scales are fp32 and symmetric (no zero point): a quantized value
    decodes as ``q * scale``.
  * Per-channel weight scales are fit over the contraction axis and kept as
    an (N,)-wide vector (or (G, N) per expert), the shape of the kernels'
    ``scale_vec`` epilogue operand.  Per-tensor scales are broadcast to the
    same shape, so every consumer handles one operand layout.
  * ``dot_error_bound`` is what the conformance tests assert: round to
    nearest puts an element within ``scale / 2`` (int) or ``eps * |x|``
    (fp8) of its value, and a K-long dot accumulates K cross terms.

fp8 casts: ``Tensor.to(torch.float8_e4m3fn)`` saturates a value past the
format's finite range to +-448, where the reference's ml_dtypes cast gives
NaN.  ``quantize_fp8`` scales into range first, so the two agree on every
value it produces; nothing here casts an out-of-range value.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

INT8_LEVELS = 127
INT4_LEVELS = 7

# fp8 type, finite max and round-off epsilon per format: e4m3 has a 3-bit
# mantissa (max 448), e5m2 a 2-bit mantissa (max 57344).
FP8_FORMATS: dict[str, tuple[torch.dtype, float, float]] = {
    "e4m3": (torch.float8_e4m3fn, 448.0, 2.0 ** -3),
    "e5m2": (torch.float8_e5m2, 57344.0, 2.0 ** -2),
}

MODES = ("none", "w8", "w4", "int8", "fp8_e4m3", "fp8_e5m2")

F32 = torch.float32


@dataclass(frozen=True)
class QuantConfig:
    """Per-layer quantization policy (hashable, like ``Epilogue``).

    ``mode``:
      * ``"none"``: full precision (the config is a no-op);
      * ``"w8"``: weight-only int8, per-channel weight scales, activations
        stay bf16 / fp32, the dequant vector multiplies at the flush;
      * ``"w4"``: weight-only int4, the same math at 7 levels, the weights
        stored nibble-packed and unpacked to int8 ahead of the kernel;
      * ``"int8"``: dynamic full int8, a per-tensor activation scale times
        the per-channel weight scale, int8 x int8 summed in int32, one
        combined (N,) scale at the flush;
      * ``"fp8_e4m3"`` / ``"fp8_e5m2"``: both operands cast to fp8 with
        per-tensor scales, summed in fp32."""
    mode: str = "none"
    per_channel: bool = True

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown quant mode: {self.mode!r} "
                             f"(expected one of {MODES})")

    @property
    def is_noop(self) -> bool:
        return self.mode == "none"

    @property
    def weight_only(self) -> bool:
        return self.mode in ("w8", "w4")

    @property
    def weight_bytes(self) -> int:
        """The weight's element width as the kernel reads it (int4 unpacks
        to int8 before the kernel, so 1; at rest it is half a byte)."""
        return 2 if self.mode == "none" else 1

    @property
    def levels(self) -> int:
        return INT4_LEVELS if self.mode == "w4" else INT8_LEVELS


def resolve(quant: "QuantConfig | str | None") -> QuantConfig:
    """A ``QuantConfig``, a mode string, or None (the no-op)."""
    if quant is None:
        return QuantConfig()
    if isinstance(quant, str):
        return QuantConfig(mode=quant)
    return quant


# ---------------------------------------------------------------------------
# The rounding rule
# ---------------------------------------------------------------------------

def scale_from_absmax(absmax: torch.Tensor, levels: int = INT8_LEVELS,
                      eps: float = 1e-30) -> torch.Tensor:
    """Symmetric scale covering ``[-absmax, absmax]`` in ``levels`` steps."""
    return torch.clamp_min(absmax.to(F32), eps) / levels


def _amax(x: torch.Tensor, dim=None) -> torch.Tensor:
    """max |x| in fp32.  Taken in x's own type and widened after: |x| and
    the max are exact in any float type, and so is the widening."""
    a = x.abs()
    a = a.amax() if dim is None else a.amax(dim=dim)
    return a.to(F32)


def symmetric_scale(x: torch.Tensor, levels: int = INT8_LEVELS,
                    dim=None) -> torch.Tensor:
    """The symmetric scale from ``max |x|``: per tensor (``dim`` None, a
    scalar) or reduced over ``dim`` (per channel / per expert)."""
    return scale_from_absmax(_amax(x, dim), levels)


def quantize(x: torch.Tensor, scale: torch.Tensor,
             levels: int = INT8_LEVELS,
             dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Clip-round symmetric quantization: ``clip(round(x / scale))``."""
    q = torch.clamp(torch.round(x.to(F32) / scale), -levels, levels)
    return q.to(dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = F32) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def error_residual(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """What quantization dropped: carried into the next step's input by
    error-feedback schemes."""
    return x.to(F32) - dequantize(q, scale)


# ---------------------------------------------------------------------------
# int4 nibble packing
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-7, 7] two to a byte along the last axis (which
    must be even): element 2i in the low nibble, 2i+1 in the high."""
    if q.shape[-1] % 2:
        raise ValueError(f"last axis must be even to pack, got "
                         f"{tuple(q.shape)}")
    lo = q[..., 0::2].to(torch.int8) & 0x0F
    hi = (q[..., 1::2].to(torch.int8) & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: both nibbles sign-extended back to int8."""
    p = packed.to(torch.int8)
    lo = (p << 4) >> 4              # arithmetic shifts sign-extend
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


# ---------------------------------------------------------------------------
# fp8 casts
# ---------------------------------------------------------------------------

def quantize_fp8(x: torch.Tensor,
                 fmt: str = "e4m3") -> tuple[torch.Tensor, torch.Tensor]:
    """Cast to fp8 with a per-tensor scale that fills the format's range.
    Returns (q, scale) with ``q * scale`` the decoded value."""
    dt, fmax, _ = FP8_FORMATS[fmt]
    scale = scale_from_absmax(_amax(x), levels=1) / fmax
    return (x.to(F32) / scale).to(dt), scale


# ---------------------------------------------------------------------------
# Operand quantization for the GEMMs
# ---------------------------------------------------------------------------

def quantize_weights(w: torch.Tensor,
                     cfg: QuantConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a (K, N) weight panel, or (G, K, N) per-expert panels, for
    ``cfg.mode``.  Returns ``(q, scale)``, ``scale`` always an (N,) fp32
    vector (or (G, N)): per-channel scales are fit over the contraction
    axis, a per-tensor scale is broadcast."""
    n = w.shape[-1]
    if cfg.mode in ("fp8_e4m3", "fp8_e5m2"):
        q, s = quantize_fp8(w, cfg.mode[4:])
        return q, s.expand(*w.shape[:-2], n)
    if cfg.mode not in ("w8", "w4", "int8"):
        raise ValueError(f"no weight quantization for mode {cfg.mode!r}")
    if cfg.per_channel:
        scale = symmetric_scale(w, cfg.levels, dim=w.ndim - 2)
        step = scale if w.ndim == 2 else scale[..., None, :]
    else:
        step = symmetric_scale(w, cfg.levels)
        scale = step.expand(*w.shape[:-2], n)
    return quantize(w, step, cfg.levels), scale


def quantize_activations(x: torch.Tensor, cfg: QuantConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor activation quantization for ``"int8"`` and the
    fp8 modes.  Returns (q, scalar scale)."""
    if cfg.mode in ("fp8_e4m3", "fp8_e5m2"):
        return quantize_fp8(x, cfg.mode[4:])
    scale = symmetric_scale(x, INT8_LEVELS)
    return quantize(x, scale, INT8_LEVELS), scale


# ---------------------------------------------------------------------------
# Analytic conformance bound
# ---------------------------------------------------------------------------

def dot_error_bound(k: int, amax_a: float, amax_b: float,
                    step_a: float = 0.0, step_b: float = 0.0) -> float:
    """Worst-case |quantized - exact| for one element of a K-long dot.

    Each element moves by at most half a step; each product then errs by
    at most ``|a| db + (|b| + db) da`` with ``da = step_a / 2``, ``db =
    step_b / 2``, and K products accumulate.  Weight-only passes ``step_a
    = 0``; fp8 callers pass ``fp8_step``."""
    da, db = step_a / 2.0, step_b / 2.0
    return k * (amax_a * db + (amax_b + db) * da)


def fp8_step(amax: float, fmt: str) -> float:
    """The absolute step fp8 round-off implies at magnitude ``amax``:
    ``2 * eps * amax``."""
    _, _, eps = FP8_FORMATS[fmt]
    return 2.0 * eps * amax
