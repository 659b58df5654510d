"""The stacks of the dense, MoE, SSM, hybrid, encoder-decoder and
vision-language families: per-layer modules, the training forward and the
cached forward.

The reference scans one traced body over layer-stacked parameters
(``lax.scan``); PyTorch runs eagerly, so here each layer is its own module
and the stack is a Python loop over them.  Caches keep the reference's
layer-stacked layout -- dense (L, B, S, KVH, D), the paged pool
(L, P, page, KVH, D), the SSM state h (L, B, H, P, N) and conv window
(L, B, W - 1, C) -- and are written in place.  The training stack
(``stack_train``) rematerialises each block in its backward when
``cfg.remat`` is "full" (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the scan body; the hybrid's reference remats a whole
group of ``attn_every`` layers, which moves memory, not values) or "dots"
(the same checkpoint, but the non-batched products' outputs are kept from
the forward and not launched again: ``dispatch.DotsStash``, the
reference's ``dots_with_no_batch_dims_saveable``).

The hybrid (zamba2) runs groups of ``attn_every`` Mamba2 layers, each group
followed by ONE shared attention + MLP block -- the same module at every
application, never a copy -- and then the remaining Mamba2 layers with no
attention after them (zamba2-7b's 81 layers: 13 groups of 6, then 3).

The encoder-decoder (whisper) runs its encoder as a non-causal stack of
dense blocks (``stack_train(..., causal=False)``), and each decoder block
attends, after its self-attention, to the encoder rows through its own
``cross`` projections (``dense_block(..., cross_kv=)``); the cross K / V are
computed once per prefill and cached as ``cross_k`` / ``cross_v``.  The
vision-language decoder (llava) is a dense stack whose sequence starts with
the projected patch rows (``models.model``).

On a training mesh (``DistContext(sharded_params=True)``) each block's
parameters are this rank's blocks, brought to the layout the block's
compute reads by ``launch.sharding.gathered`` inside the rematerialised
function, so the recompute gathers them again (ZeRO-3).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.gemm.dispatch import DotsStash
from ..launch.sharding import gathered
from .attention import AttentionParams, attention, init_attention_params, param
from .layers import rms_norm, swiglu
from .moe import MoEParams, init_moe_params, moe_mlp
from .ssm import (SSMParams, conv_tail, init_ssm_params, init_ssm_state,
                  ssd_decode_step, ssd_forward)

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
RECURRENT_FAMILIES = ("ssm", "hybrid")


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
    """One decoder layer: ln1 -> attention -> [ln_cross -> cross-attention]
    -> ln2 -> the SwiGLU MLP (``mlp``) or the routed experts (``moe``, MoE
    family; ``mlp`` is then None).  ``cross`` / ``ln_cross``: the
    encoder-decoder's cross-attention projections (no qk-norm), None
    elsewhere.  The norm scales stay fp32 (the norm runs in fp32 either
    way)."""

    def __init__(self, ln1, attn: AttentionParams, ln2,
                 mlp: MLPParams | None = None, moe: MoEParams | None = None,
                 *, ln_cross=None, cross: AttentionParams | None = None,
                 requires_grad: bool = False):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a block has either an MLP or experts")
        if (ln_cross is None) != (cross is None):
            raise ValueError("cross-attention needs its norm and projections")
        self.ln1 = param(ln1, requires_grad)
        self.ln2 = param(ln2, requires_grad)
        self.attn, self.mlp, self.moe = attn, mlp, moe
        self.ln_cross = (None if ln_cross is None
                         else param(ln_cross, requires_grad))
        self.cross = cross


class SSMBlock(nn.Module):
    """One Mamba2 layer: ln -> the SSD mixer (``ssm``), residual added.
    The norm scale stays fp32."""

    def __init__(self, ln, ssm: SSMParams, *, requires_grad: bool = False):
        super().__init__()
        self.ln = param(ln, requires_grad)
        self.ssm = ssm


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (the port runs "
            f"{', '.join(PORTED_FAMILIES)})")


def init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                     device: torch.device, dtype: torch.dtype,
                     requires_grad: bool = False, *,
                     cross: bool = False) -> DenseBlock:
    """The reference's initialisation, drawn from ``gen``: He-scaled normal
    projections in ``dtype``, zero fp32 norm scales.  ``cross``: with the
    encoder-decoder's cross-attention (``ln_cross`` and ``cross``)."""
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
    if cross:
        ffn.update(ln_cross=torch.zeros(d, device=device),
                   cross=init_attention_params(
                       gen, d, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim_, qk_norm=False, dtype=dt,
                       device=device, requires_grad=rg))
    zeros = torch.zeros(d, device=device)
    return DenseBlock(zeros, attn, zeros.clone(), **ffn, requires_grad=rg)


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig,
                   device: torch.device, dtype: torch.dtype,
                   requires_grad: bool = False) -> SSMBlock:
    return SSMBlock(torch.zeros(cfg.d_model, device=device),
                    init_ssm_params(gen, cfg.d_model, cfg.ssm_state,
                                    dtype=dtype, device=device,
                                    requires_grad=requires_grad),
                    requires_grad=requires_grad)


def dense_block(h: torch.Tensor, p: DenseBlock, cfg: ModelConfig, *,
                positions: torch.Tensor, window: int, kv=None,
                cache_index=None, causal: bool = True, use_rope: bool = True,
                page_table: torch.Tensor | None = None, cross_kv=None):
    """Returns (h, new_kv, aux).  The residual adds ride the
    out-projections' fused epilogues instead of separate elementwise
    passes; an MoE block adds its experts' output to the residual stream
    after them.  ``aux`` is the MoE block's load-balancing loss, None for a
    dense block.  ``cross_kv``: the encoder rows' (K, V) for this block's
    cross-attention, run after the self-attention (no rope, no qk-norm,
    non-causal)."""
    cdt = compute_dtype(cfg)
    h, new_kv = attention(
        rms_norm(h, p.ln1), p.attn,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim_, positions=positions, window=window,
        causal=causal, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        use_rope=use_rope, kv_cache=kv, cache_index=cache_index,
        compute_dtype=cdt, residual=h, page_table=page_table)
    if cross_kv is not None:
        h, _ = attention(
            rms_norm(h, p.ln_cross), p.cross,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim_, positions=positions, cross_kv=cross_kv,
            compute_dtype=cdt, residual=h)
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


def ssm_block(h: torch.Tensor, p: SSMBlock, cfg: ModelConfig,
              state: dict | None = None):
    """Returns (h, new_state).  No ``state``: the training forward (new
    state None).  One token: the recurrent decode step.  More: the chunked
    scan from ``state["h"]`` and a fresh conv tail (the prompt's own conv
    inputs; the conv window in ``state`` is not read, as in the
    reference's prefill)."""
    cdt = compute_dtype(cfg)
    x = rms_norm(h, p.ln)
    kw = dict(ssm_state=cfg.ssm_state, compute_dtype=cdt)
    if state is None:
        y, _ = ssd_forward(x, p.ssm, chunk=cfg.ssm_chunk, **kw)
        return h + y, None
    if x.shape[1] == 1:
        y, new_state = ssd_decode_step(x, p.ssm, state, **kw)
        return h + y, new_state
    y, h_final = ssd_forward(x, p.ssm, chunk=cfg.ssm_chunk,
                             initial_state=state["h"], **kw)
    return h + y, {"h": h_final, "conv": conv_tail(x, p.ssm, **kw)}


def _shared_after(cfg: ModelConfig, layer: int) -> int | None:
    """The hybrid's group index whose shared block follows ``layer``, or
    None (inside a group, the remainder, or a pure SSM stack)."""
    if cfg.family != "hybrid" or (layer + 1) % cfg.attn_every:
        return None
    return (layer + 1) // cfg.attn_every - 1


def _remat(fn, cfg: ModelConfig, *args):
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        stash = DotsStash()

        def run(*a):
            with stash.active():
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False)


def stack_train(layers: nn.ModuleList, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, *, shared: DenseBlock | None = None,
                cross_kv_stack: list | None = None, causal: bool = True,
                use_rope: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stack without caches (training; the encoder, with
    ``causal=False``).  -> (h, aux), ``aux`` the MoE load-balancing losses
    summed over the layers (0 for the other families).  ``shared``: the
    hybrid's shared attention + MLP block.  ``cross_kv_stack``: one (K, V)
    of the encoder rows per layer, for the encoder-decoder's
    cross-attention.  ``cfg.remat``: "full" recomputes each block in the
    backward (non-reentrant ``torch.utils.checkpoint``), "dots" too but
    keeps the outputs of its non-batched products from the forward, "none"
    keeps every activation."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat {cfg.remat!r} (the reference's "
                         "'full', 'dots' and 'none')")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cdt = compute_dtype(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        def shared_block(hh):
            with gathered(shared, dtype=cdt):
                return dense_block(hh, shared, cfg, positions=positions,
                                   window=0)[0]

        def mamba_block(hh, p):
            with gathered(p, dtype=cdt):
                return ssm_block(hh, p, cfg)[0]
        for layer, p in enumerate(layers):
            h = _remat(mamba_block, cfg, h, p)
            if _shared_after(cfg, layer) is not None:
                h = _remat(shared_block, cfg, h)
        return h, aux
    # The encoder takes the first encoder_layers windows, as the reference.
    for layer, (p, w) in enumerate(zip(layers, cfg.windows())):
        def block(hh, *ckv, p=p, w=w):
            with gathered(p, dtype=cdt):
                out, _, a = dense_block(hh, p, cfg, positions=positions,
                                        window=w, causal=causal,
                                        use_rope=use_rope,
                                        cross_kv=ckv or None)
            return out, a
        ckv = () if cross_kv_stack is None else cross_kv_stack[layer]
        h, a = _remat(block, cfg, h, *ckv)
        if a is not None:
            aux = aux + a
    return h, aux


def stack_cached(layers: nn.ModuleList, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor, cache: dict, cache_index, *,
                 shared: DenseBlock | None = None, causal: bool = True,
                 use_rope: bool = True,
                 page_table: torch.Tensor | None = None):
    """Run the stack with its caches (prefill and decode), writing each
    layer's K/V or SSM state into ``cache`` in place.  -> (h, cache).
    ``page_table`` (B, max_pages): the cache leaves are paged pools shared
    by every slot (one table for every layer; attention families only).
    ``shared``: the hybrid's shared block, whose K/V go to
    ``cache["attn_k"][group]``.  The encoder-decoder's blocks read their
    cross K / V from ``cache["cross_k"][layer]`` / ``["cross_v"]`` (written
    by the prefill) and never change them."""
    cdt = compute_dtype(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        if page_table is not None:
            raise ValueError(f"paged KV unsupported for {cfg.family}")
        hk, ck = (("h", "conv") if cfg.family == "ssm"
                  else ("ssm_h", "ssm_conv"))
        for layer, p in enumerate(layers):
            with gathered(p, dtype=cdt):
                h, new = ssm_block(h, p, cfg,
                                   state={"h": cache[hk][layer],
                                          "conv": cache[ck][layer]})
            cache[hk][layer].copy_(new["h"])
            cache[ck][layer].copy_(new["conv"])
            group = _shared_after(cfg, layer)
            if group is not None:
                with gathered(shared, dtype=cdt):
                    h, _, _ = dense_block(
                        h, shared, cfg, positions=positions, window=0,
                        kv=(cache["attn_k"][group], cache["attn_v"][group]),
                        cache_index=cache_index, causal=causal,
                        use_rope=use_rope)
        return h, cache
    encdec = cfg.family == "encdec"
    if encdec and page_table is not None:
        raise ValueError("paged KV unsupported for encdec")
    for layer, (p, w) in enumerate(zip(layers, cfg.windows())):
        with gathered(p, dtype=cdt):
            h, _, _ = dense_block(
                h, p, cfg, positions=positions, window=w,
                kv=(cache["k"][layer], cache["v"][layer]),
                cache_index=cache_index, causal=causal, use_rope=use_rope,
                page_table=page_table,
                cross_kv=((cache["cross_k"][layer], cache["cross_v"][layer])
                          if encdec else None))
    return h, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype: torch.dtype | None = None, *,
               head_shard: int = 1) -> dict:
    """Zero caches with the reference's keys: k / v (dense, moe, vlm;
    encdec adds cross_k / cross_v of the ``encoder_seq`` encoder rows); h /
    conv (ssm); ssm_h / ssm_conv and the shared block's attn_k / attn_v,
    one per group (hybrid).  The SSM state h is fp32; ``head_shard``: the
    SSM state of one rank's heads (``ssm.init_ssm_state``)."""
    check_family(cfg)
    dtype = dtype or compute_dtype(cfg)
    kv = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    if cfg.family not in RECURRENT_FAMILIES:
        layers = (cfg.num_layers,)
        cache = {"k": torch.zeros(layers + kv, dtype=dtype, device=device),
                 "v": torch.zeros(layers + kv, dtype=dtype, device=device)}
        if cfg.family == "encdec":
            cross = layers + (batch, cfg.encoder_seq) + kv[2:]
            cache["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
            cache["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
        return cache
    st = init_ssm_state(batch, cfg.d_model, cfg.ssm_state, dtype=dtype,
                        device=device, head_shard=head_shard)
    h, conv = (t.new_zeros((cfg.num_layers,) + t.shape)
               for t in (st["h"], st["conv"]))
    if cfg.family == "ssm":
        return {"h": h, "conv": conv}
    groups = cfg.num_layers // cfg.attn_every
    return {"ssm_h": h, "ssm_conv": conv,
            "attn_k": torch.zeros((groups,) + kv, dtype=dtype, device=device),
            "attn_v": torch.zeros((groups,) + kv, dtype=dtype, device=device)}
