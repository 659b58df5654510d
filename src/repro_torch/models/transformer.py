"""The decoder stack of the dense and MoE families: per-layer modules, the
training forward and the cached forward.

The reference scans one traced body over layer-stacked parameters
(``lax.scan``); PyTorch runs eagerly, so here each layer is its own module
and the stack is a Python loop over them.  Caches keep the reference's
layer-stacked layout -- dense (L, B, S, KVH, D) or the paged pool
(L, P, page, KVH, D) -- and are written in place.  The training stack
(``stack_train``) rematerialises each block in its backward when
``cfg.remat`` is "full" (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the scan body).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import AttentionParams, attention, init_attention_params, param
from .layers import rms_norm, swiglu
from .moe import MoEParams, init_moe_params, moe_mlp

PORTED_FAMILIES = ("dense", "moe")


def as_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """A torch dtype from a config's name for it ("bfloat16") or itself."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return as_dtype(cfg.compute_dtype)


class MLPParams(nn.Module):
    """w_gate / w_up (D, F) and w_down (F, D)."""

    def __init__(self, w_gate, w_up, w_down, *, requires_grad: bool = False):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (
            param(t, requires_grad) for t in (w_gate, w_up, w_down))


class DenseBlock(nn.Module):
    """One decoder layer: ln1 -> attention -> ln2 -> the SwiGLU MLP
    (``mlp``, dense family) or the routed experts (``moe``, MoE family;
    ``mlp`` is then None).  The norm scales stay fp32 (the norm runs in
    fp32 either way)."""

    def __init__(self, ln1, attn: AttentionParams, ln2,
                 mlp: MLPParams | None = None, moe: MoEParams | None = None,
                 *, requires_grad: bool = False):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a block has either an MLP or experts")
        self.ln1 = param(ln1, requires_grad)
        self.ln2 = param(ln2, requires_grad)
        self.attn, self.mlp, self.moe = attn, mlp, moe


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (the port runs "
            f"{', '.join(PORTED_FAMILIES)})")


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     device: torch.device, dtype: torch.dtype,
                     requires_grad: bool = False) -> DenseBlock:
    """The reference's initialisation, drawn from ``gen``: He-scaled normal
    projections in ``dtype``, zero fp32 norm scales."""
    dt, rg = dtype, requires_grad
    d, f = cfg.d_model, cfg.d_ff

    def he(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device)
                * (2.0 / fan_in) ** 0.5).to(dt)

    attn = init_attention_params(
        gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
        qk_norm=cfg.qk_norm, dtype=dt, device=device, requires_grad=rg)
    if cfg.family == "moe":
        ffn = {"moe": init_moe_params(gen, d, f, cfg.num_experts, dtype=dt,
                                      device=device, requires_grad=rg)}
    else:
        ffn = {"mlp": MLPParams(he((d, f), d), he((d, f), d), he((f, d), f),
                                requires_grad=rg)}
    zeros = torch.zeros(d, device=device)
    return DenseBlock(zeros, attn, zeros.clone(), **ffn, requires_grad=rg)


def dense_block(h: torch.Tensor, p: DenseBlock, cfg: ModelConfig, *,
                positions: torch.Tensor, window: int, kv=None,
                cache_index=None, causal: bool = True, use_rope: bool = True,
                page_table: torch.Tensor | None = None):
    """Returns (h, new_kv, aux).  The residual adds ride the
    out-projections' fused epilogues instead of separate elementwise
    passes; an MoE block adds its experts' output to the residual stream
    after them.  ``aux`` is the MoE block's load-balancing loss, None for a
    dense block."""
    cdt = compute_dtype(cfg)
    h, new_kv = attention(
        rms_norm(h, p.ln1), p.attn,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, window=window,
        causal=causal, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        use_rope=use_rope, kv_cache=kv, cache_index=cache_index,
        compute_dtype=cdt, residual=h, page_table=page_table)
    x = rms_norm(h, p.ln2)
    if p.moe is not None:
        b, s, d = x.shape
        y, aux = moe_mlp(x.reshape(b * s, d), p.moe,
                         num_experts=cfg.num_experts, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         compute_dtype=cdt, dispatch=cfg.moe_dispatch,
                         quant=cfg.quant)
        return h + y.reshape(b, s, d), new_kv, aux
    h = swiglu(x, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down, cdt, residual=h)
    return h, new_kv, None


def stack_train(layers: nn.ModuleList, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                use_rope: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stack without caches (training).  -> (h, aux), ``aux`` the
    MoE load-balancing losses summed over the layers (0 for a dense
    stack).  ``cfg.remat``: "full" recomputes each block in the backward
    (non-reentrant ``torch.utils.checkpoint``), "none" keeps every
    activation."""
    if cfg.remat not in ("full", "none"):
        raise NotImplementedError(
            f"remat={cfg.remat!r}: the port runs 'full' and 'none'")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, w in zip(layers, cfg.windows()):
        def block(hh, p=p, w=w):
            out, _, a = dense_block(hh, p, cfg, positions=positions,
                                    window=w, causal=causal,
                                    use_rope=use_rope)
            return out, a
        if cfg.remat == "full":
            h, a = checkpoint(block, h, use_reentrant=False)
        else:
            h, a = block(h)
        if a is not None:
            aux = aux + a
    return h, aux


def stack_cached(layers: nn.ModuleList, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor, cache: dict, cache_index, *,
                 causal: bool = True, use_rope: bool = True,
                 page_table: torch.Tensor | None = None):
    """Run the stack with KV caches (prefill and decode), writing each
    layer's K/V into ``cache`` in place.  -> (h, cache).  ``page_table``
    (B, max_pages): the cache leaves are paged pools shared by every slot
    (one table for every layer)."""
    for layer, (p, w) in enumerate(zip(layers, cfg.windows())):
        h, _, _ = dense_block(
            h, p, cfg, positions=positions, window=w,
            kv=(cache["k"][layer], cache["v"][layer]),
            cache_index=cache_index, causal=causal, use_rope=use_rope,
            page_table=page_table)
    return h, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype: torch.dtype | None = None) -> dict:
    check_family(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dtype = dtype or compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
