"""The four input-shape suites (copied from the JAX package's
configs/shapes.py; LM shapes are seq_len x global_batch).

decode_* / long_* are one serving step (one new token against a KV cache
of seq_len), not a train step.  long_500k needs sub-quadratic attention
and runs only for the archs with ``supports_long_context``.
"""
from __future__ import annotations

from .base import ShapeConfig

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}


def applicable(cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k decode KV is "
                       "quadratic-prefill territory; skipped per assignment")
    return True, ""
