"""Prompt-length buckets and the CMR-priced serve cost model.

A small geometric ladder of prompt capacities bounds the set of prefill
shapes the engine runs (right-padding is exact for causal attention, see
``models.model.prefill_bucket``); every admission maps to the smallest
bucket that fits, and a prompt beyond the ladder takes the exact-length
prefill rung.

Pricing goes through the port's CMR planner: each bucket's prefill and the
fused decode tick decompose into the GEMM signatures of the stack, and
``plan_gemm`` prices each one (which also plans every serving signature
before the first request).  The CMR numbers only rank tiles, so
``CostModel`` calibrates them against measured wall times: observed buckets
use their wall EWMA directly, never-observed buckets scale their model
price by the measured/modeled ratio of the buckets that have run.
Admission control (``engine.ServeEngine.submit``) prices deadlines against
these estimates.  The measured-plan store is not ported yet, so its
lookup / hit counters read 0.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..core.gemm import plan_gemm

__all__ = ["make_buckets", "bucket_for", "gemm_signatures", "CostModel"]

_EWMA_ALPHA = 0.3


def make_buckets(max_prompt: int, *, smallest: int = 32,
                 growth: int = 2) -> tuple[int, ...]:
    """Geometric bucket ladder ``smallest, smallest*growth, ... >= max_prompt``;
    padding waste per request is at most (growth-1)/growth of the bucket."""
    if max_prompt < 1:
        raise ValueError(f"max_prompt={max_prompt}")
    buckets = [min(smallest, max_prompt)]
    while buckets[-1] < max_prompt:
        buckets.append(min(buckets[-1] * growth, max_prompt))
    return tuple(buckets)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int | None:
    """Smallest bucket holding ``length`` tokens; None = miss (exact rung)."""
    for b in buckets:
        if length <= b:
            return b
    return None


def gemm_signatures(cfg: ModelConfig, m: int) -> list[tuple[int, int, int]]:
    """Per-layer (m, k, n) GEMM signatures of one stack pass over ``m``
    token rows; callers multiply by ``cfg.num_layers``."""
    d, h, kvh, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim_)
    return [
        (m, d, (h + 2 * kvh) * hd),     # qkv projections
        (m, h * hd, d),                 # attention output projection
        (m, d, 2 * cfg.d_ff),           # ffn gate+up
        (m, cfg.d_ff, d),               # ffn down
    ]


def _stack_price_s(cfg: ModelConfig, m: int, logit_rows: int) -> float:
    """Modeled seconds for one stack pass over ``m`` rows plus the unembed
    over ``logit_rows`` rows, via ``plan_gemm``."""
    width = getattr(torch, cfg.compute_dtype).itemsize
    t = 0.0
    for (mm, k, n) in gemm_signatures(cfg, m):
        t += plan_gemm(mm, k, n, width, width).t_total * cfg.num_layers
    t += plan_gemm(logit_rows, cfg.d_model, cfg.vocab_size, width,
                   width).t_total
    return t


@dataclasses.dataclass
class CostModel:
    """CMR-relative, measurement-calibrated serve pricing.

    ``observe_*`` feed measured wall times; ``prefill_s`` / ``step_s``
    return calibrated estimates, or None while nothing has been measured
    (admission control admits unconditionally until calibrated)."""
    cfg: ModelConfig
    buckets: tuple[int, ...]
    slots: int
    model_prefill: dict = dataclasses.field(default_factory=dict)
    model_step: float = 0.0
    obs_prefill: dict = dataclasses.field(default_factory=dict)
    obs_step: float | None = None
    warmed: int = 0
    store_lookups: int = 0
    store_hits: int = 0

    def __post_init__(self):
        for b in self.buckets:
            # A bucket prefill runs the whole batch's rows through the
            # stack in one pass; logits are one row per request.
            self.model_prefill[b] = _stack_price_s(
                self.cfg, self.slots * b, self.slots)
            self.warmed += len(gemm_signatures(self.cfg, self.slots * b)) + 1
        self.model_step = _stack_price_s(self.cfg, self.slots, self.slots)
        self.warmed += len(gemm_signatures(self.cfg, self.slots)) + 1

    # -- measurement feedback --------------------------------------------

    def observe_prefill(self, bucket: int, wall_s: float) -> None:
        prev = self.obs_prefill.get(bucket)
        self.obs_prefill[bucket] = (wall_s if prev is None else
                                    prev + _EWMA_ALPHA * (wall_s - prev))

    def observe_step(self, wall_s: float) -> None:
        self.obs_step = (wall_s if self.obs_step is None else
                         self.obs_step + _EWMA_ALPHA
                         * (wall_s - self.obs_step))

    # -- calibrated estimates --------------------------------------------

    def _scale(self) -> float | None:
        """Measured/modeled ratio averaged over observed buckets."""
        ratios = [wall / self.model_prefill[b]
                  for b, wall in self.obs_prefill.items()
                  if self.model_prefill.get(b, 0.0) > 0.0]
        if not ratios:
            return None
        return sum(ratios) / len(ratios)

    def prefill_s(self, bucket: int | None) -> float | None:
        """Estimated wall seconds for one batch prefill at ``bucket``
        (None = the exact rung, priced as the largest bucket)."""
        if bucket is None:
            bucket = self.buckets[-1]
        wall = self.obs_prefill.get(bucket)
        if wall is not None:
            return wall
        scale = self._scale()
        if scale is None:
            return None
        model = self.model_prefill.get(bucket)
        if model is None:
            model = _stack_price_s(self.cfg, self.slots * bucket, self.slots)
            self.model_prefill[bucket] = model
        return model * scale

    def step_s(self) -> float | None:
        return self.obs_step

    def calibrated(self) -> bool:
        return self.obs_step is not None and bool(self.obs_prefill)

    def snapshot(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "warmed_signatures": self.warmed,
            "store_lookups": self.store_lookups,
            "store_hits": self.store_hits,
            "model_prefill_s": {str(b): self.model_prefill[b]
                                for b in self.buckets},
            "model_step_s": self.model_step,
            "observed_buckets": sorted(self.obs_prefill),
            "step_ewma_s": self.obs_step,
        }
