"""Top-level model API of the dense and MoE decoders: init / prefill /
bucketed prefill / decode, and the KV cache.

Batch dict convention, as in the reference: ``tokens`` (B, S) int.  The
parameters are one ``DenseLM`` module (the reference's parameter pytree):
the (V_pad, D) embedding table in the compute dtype, shared by the embed
and the unembed, the fp32 final-norm scale, and one ``DenseBlock`` per
layer, whose feed-forward is a SwiGLU MLP (dense) or routed experts (moe).
Forward only: serving needs no gradient.

In the capacity-dispatch MoE, every token of a stack pass is routed and
takes capacity, the right-padding of a bucket prefill and the idle slots of
a decode step included -- as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from .attention import frozen
from .layers import embed, rms_norm, unembed
from .transformer import (DenseBlock, check_family, compute_dtype,
                          init_cache, init_dense_block, stack_cached)

__all__ = ["DenseLM", "init_params", "prefill", "prefill_bucket",
           "decode_step", "make_cache"]


class DenseLM(nn.Module):
    def __init__(self, embed_table: torch.Tensor, final_norm: torch.Tensor,
                 layers: list[DenseBlock]):
        super().__init__()
        self.embed = frozen(embed_table)
        self.final_norm = frozen(final_norm)
        self.layers = nn.ModuleList(layers)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> DenseLM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, with
    the reference's distributions (embedding N(0, 0.02^2), He-scaled
    projections, router and experts, zero norm scales).  Runs on the CUDA card unless
    ``device`` says otherwise; raises when no card is present and no device
    is given."""
    check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    table = (torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen,
                         device=device) * 0.02).to(compute_dtype(cfg))
    layers = [init_dense_block(gen, cfg, device)
              for _ in range(cfg.num_layers)]
    return DenseLM(table, torch.zeros(cfg.d_model, device=device), layers)


def _embed_inputs(model: DenseLM, cfg: ModelConfig, batch: dict):
    h = embed(batch["tokens"], model.embed, compute_dtype(cfg))
    return h, torch.arange(h.shape[1], device=h.device)


def make_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device: torch.device) -> dict:
    """KV cache sized for ``max_len`` positions."""
    return init_cache(cfg, batch_size, max_len, device)


@torch.no_grad()
def prefill(model: DenseLM, cfg: ModelConfig, batch: dict,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the stack, filling ``cache`` in place.
    Returns (last-position logits (B, V), cache)."""
    h, positions = _embed_inputs(model, cfg, batch)
    h, cache = stack_cached(model.layers, cfg, h, positions, cache, 0)
    h = rms_norm(h[:, -1:], model.final_norm)
    logits = unembed(h, model.embed, cfg.vocab_size, compute_dtype(cfg))
    return logits[:, 0], cache


@torch.no_grad()
def prefill_bucket(model: DenseLM, cfg: ModelConfig, batch: dict,
                   cache: dict, lens: torch.Tensor
                   ) -> tuple[torch.Tensor, dict]:
    """Length-bucketed batch prefill: right-padded prompts (``lens`` (B,)
    true lengths) run through one stack pass, and each row's logits are
    taken at its own last valid position.  Causality makes the padding
    exact: row r's logits at lens[r]-1 attend only to positions below
    lens[r].  Returns ((B, V) logits, cache)."""
    h, positions = _embed_inputs(model, cfg, batch)
    h, cache = stack_cached(model.layers, cfg, h, positions, cache, 0)
    idx = lens.to(device=h.device, dtype=torch.long) - 1
    last = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
    last = rms_norm(last, model.final_norm)
    logits = unembed(last, model.embed, cfg.vocab_size, compute_dtype(cfg))
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(model: DenseLM, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor | int,
                page_table: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  ``tokens`` (B, 1); ``pos`` the number of positions
    already in the cache, an int or a (B,) vector of per-slot depths (slots
    at mixed depths in one step, each writing and masking at its own row).
    ``page_table`` (B, max_pages): ``cache`` holds paged pools shared by
    every slot (``serve.kv_pages``).  Returns (logits (B, V), cache)."""
    h = embed(tokens, model.embed, compute_dtype(cfg))
    if isinstance(pos, torch.Tensor) and pos.ndim:
        pos = pos.to(device=h.device, dtype=torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.arange(pos, pos + 1, device=h.device)
    h, cache = stack_cached(model.layers, cfg, h, positions, cache, pos,
                            page_table=page_table)
    h = rms_norm(h, model.final_norm)
    logits = unembed(h, model.embed, cfg.vocab_size, compute_dtype(cfg))
    return logits[:, 0], cache
