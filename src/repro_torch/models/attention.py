"""Attention: GQA with qk-norm, RoPE, sliding-window / chunked / global masks,
blockwise (memory-efficient) computation, and KV-cache decode.

Window encoding per layer (a Python int here):

    window > 0  : sliding window of that size (SWA)
    window == 0 : global attention
    window < 0  : chunked/local attention with chunk size |window|

The score and value products (``_bmm_qk`` / ``_bmm_pv``) are the paper's
irregular batched GEMMs -- at decode, K = cache length >> M = query group --
and run through ``batched_matmul`` on the grouped ftIMM kernel, in fp32 as
in the reference.  The softmax around them is plain PyTorch, as the
reference composes it with jnp, so the training path (``blockwise_attention``
without a cache) is differentiable end to end: its backward runs the
grouped kernel's dX / dW products.

Under a ``core.dist.DistContext`` with ``sp_decode`` and a model axis of
more than one rank, a scalar-position decode takes ``flash_decode``, the
paper's K-parallel strategy across ranks: each rank holds the cache rows
[s S_l, (s+1) S_l) (``models.model.make_cache`` builds that block), writes
a token's K / V only where it owns the row, computes its partial
attention over its block and the partials merge with the log-sum-exp
correction over the model axis.  The paged and per-row-position branches
stay single-device, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.dist import current_dist
from ..core.gemm import batched_matmul, collective
from .layers import dense, rms_norm, rope

NEG_INF = -1e30
_PAD_POS = (2 ** 31 - 1) // 2      # position of padded KV rows (never valid)


def param(t: torch.Tensor, requires_grad: bool = False) -> nn.Parameter:
    """A weight of the model: frozen for serving, trainable for training."""
    return nn.Parameter(t, requires_grad=requires_grad)


class AttentionParams(nn.Module):
    """wq (D, H*hd), wk / wv (D, KVH*hd), wo (H*hd, D); the qk-norm scales
    (hd,) in fp32 when the config has qk_norm."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None, *,
                 requires_grad: bool = False):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (
            param(t, requires_grad) for t in (wq, wk, wv, wo))
        self.q_norm = None if q_norm is None else param(q_norm, requires_grad)
        self.k_norm = None if k_norm is None else param(k_norm, requires_grad)


def init_attention_params(gen: torch.Generator, d_model: int, num_heads: int,
                          num_kv_heads: int, head_dim: int, *,
                          qk_norm: bool, dtype: torch.dtype,
                          device: torch.device,
                          requires_grad: bool = False) -> AttentionParams:
    """The reference's initialisation (normal, He-scaled), drawn from
    ``gen`` in fp32 and cast to ``dtype``."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device)
                * (2.0 / fan_in) ** 0.5).to(dtype)

    norms = ({"q_norm": torch.zeros(head_dim, device=device),
              "k_norm": torch.zeros(head_dim, device=device)}
             if qk_norm else {})
    return AttentionParams(
        normal((d_model, num_heads * head_dim), d_model),
        normal((d_model, num_kv_heads * head_dim), d_model),
        normal((d_model, num_kv_heads * head_dim), d_model),
        normal((num_heads * head_dim, d_model), num_heads * head_dim),
        **norms, requires_grad=requires_grad)


def _bmm_qk(qg: torch.Tensor, k_blk: torch.Tensor) -> torch.Tensor:
    """(B, Sq, KVH, G, D) x (B, Skv, KVH, D) -> (B, Sq, KVH, G, Skv) scores:
    (batch, kv-head) fold into the groups, (query, group) into M, each group
    an "nt" GEMM with K = head_dim."""
    b, sq, kvh, g, d = qg.shape
    skv = k_blk.shape[1]
    qf = qg.permute(0, 2, 1, 3, 4).reshape(b * kvh, sq * g, d)
    kf = k_blk.to(torch.float32).permute(0, 2, 1, 3).reshape(b * kvh, skv, d)
    s = batched_matmul(qf, kf, trans="nt", out_dtype=torch.float32)
    return s.reshape(b, kvh, sq, g, skv).permute(0, 2, 1, 3, 4)


def _bmm_pv(p: torch.Tensor, v_blk: torch.Tensor) -> torch.Tensor:
    """(B, Sq, KVH, G, Skv) x (B, Skv, KVH, D) -> (B, Sq, KVH, G, D)."""
    b, sq, kvh, g, skv = p.shape
    d = v_blk.shape[-1]
    pf = p.permute(0, 2, 1, 3, 4).reshape(b * kvh, sq * g, skv)
    vf = v_blk.to(torch.float32).permute(0, 2, 1, 3).reshape(b * kvh, skv, d)
    o = batched_matmul(pf, vf, trans="nn", out_dtype=torch.float32)
    return o.reshape(b, kvh, sq, g, d).permute(0, 2, 1, 3, 4)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
          causal: bool) -> torch.Tensor:
    """(Sq, Skv) boolean mask from positions and the window encoding."""
    q = q_pos[:, None].to(torch.int64)
    k = kv_pos[None, :].to(torch.int64)
    ok = torch.ones(q.shape[0], k.shape[1], dtype=torch.bool,
                    device=q.device)
    if causal:
        ok = k <= q
    aw = max(abs(int(window)), 1)
    if window > 0:
        ok = ok & (k > q - aw)
    elif window < 0:
        ok = ok & (torch.div(q, aw, rounding_mode="floor")
                   == torch.div(k, aw, rounding_mode="floor"))
    return ok


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        window: int = 0, causal: bool = True,
                        kv_valid_len=None, block_kv: int = 1024) -> torch.Tensor:
    """Memory-efficient attention with running max / denominator over KV
    blocks.  q (B, Sq, H, D); k, v (B, Skv, KVH, D).

    The reference pads KV to a multiple of ``block_kv``; here the block is
    clamped to the KV length first.  The padded positions get p = 0 either
    way, so only the fp32 summation order changes."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).to(torch.float32)
    scale = d ** -0.5
    block = max(min(block_kv, skv), 1)
    pad = (-skv) % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.cat([kv_positions, torch.full(
            (pad,), _PAD_POS, dtype=kv_positions.dtype,
            device=kv_positions.device)])
    valid = skv if kv_valid_len is None else kv_valid_len
    acc = torch.zeros(b, sq, kvh, g, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, sq, kvh, g, dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], block):
        k_blk, v_blk = k[:, start:start + block], v[:, start:start + block]
        pos_blk = kv_positions[start:start + block]
        s = _bmm_qk(qg, k_blk) * scale
        msk = _mask(q_positions, pos_blk, window, causal)
        msk = msk & (pos_blk < valid)[None, :]
        s = s.masked_fill(~msk[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _bmm_pv(p, v_blk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *,
                     q_pos: torch.Tensor, window: int) -> torch.Tensor:
    """Single-token decode over the whole cache with PER-ROW positions:
    q (B, 1, H, D), ck / cv (B, S, KVH, D), q_pos (B,) the cache row each
    batch entry just wrote.  Row b attends exactly k <= q_pos[b] under its
    own window, so slots at different depths share one decode batch."""
    b, sq, h, d = q.shape
    kvh = ck.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).to(torch.float32)
    s_ = _bmm_qk(qg, ck) * (d ** -0.5)                 # (B, 1, KVH, G, Skv)
    kv_pos = torch.arange(ck.shape[1], device=q.device)
    msk = _mask(q_pos, kv_pos, window, causal=True)     # (B, Skv)
    s_ = s_.masked_fill(~msk[:, None, None, None, :], NEG_INF)
    m = s_.amax(dim=-1, keepdim=True)
    p = torch.exp(s_ - m)
    out = _bmm_pv(p, cv) / torch.clamp_min(p.sum(dim=-1)[..., None], 1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype)


def sp_decoding(ctx) -> bool:
    """Whether ``ctx`` (a ``DistContext`` or None) cuts the KV cache's
    sequence over its model axis and decodes with ``flash_decode``."""
    return ctx is not None and ctx.sp_decode and ctx.model_size > 1


def flash_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *,
                 pos: int, window: int, dist) -> torch.Tensor:
    """Sequence-parallel decode attention (the reference's
    ``flash_decode``): the paper's K-parallel strategy (Alg. 5) across the
    model axis, a.k.a. flash-decoding.  q (B, 1, H, D) replicated; ck / cv
    this rank's (B, S_l, KVH, D) block of the cache, rows [s S_l, (s+1)
    S_l); ``pos`` the newest valid position.  Each rank computes its
    partial (running max m, denominator l, accumulator) over its rows with
    the grouped kernel (QK^T "nt", PV "nn", fp32 as in the reference); the
    partials merge over the model axis with the log-sum-exp correction:
    all_reduce(MAX) of m, then all_reduce(SUM) of l * corr and acc * corr.
    A rank whose rows are all masked contributes corr = 0."""
    b, _, h, d = q.shape
    s_loc, kvh = ck.shape[1], ck.shape[2]
    g = h // kvh
    mesh, axis = dist.mesh, dist.model_axis
    kv_pos = (mesh.axis_index(axis) * s_loc
              + torch.arange(s_loc, device=q.device))
    qg = q[:, 0].reshape(b * kvh, g, d).to(torch.float32)
    kf = ck.to(torch.float32).permute(0, 2, 1, 3).reshape(b * kvh, s_loc, d)
    s_ = batched_matmul(qg, kf, trans="nt", out_dtype=torch.float32
                        ).reshape(b, kvh, g, s_loc) * (d ** -0.5)
    pos_t = torch.tensor([pos], device=q.device)
    msk = _mask(pos_t, kv_pos, window, causal=True)[0]
    s_ = s_.masked_fill(~msk[None, None, None, :], NEG_INF)
    m = s_.amax(dim=-1)
    p = torch.exp(s_ - m[..., None])
    l = p.sum(dim=-1)
    vf = cv.to(torch.float32).permute(0, 2, 1, 3).reshape(b * kvh, s_loc, d)
    acc = batched_matmul(p.reshape(b * kvh, g, s_loc), vf, trans="nn",
                         out_dtype=torch.float32).reshape(b, kvh, g, d)
    # The LSE-corrected reduction over the model axis (Alg. 5 line 12).
    gm = collective.raw_all_reduce(m, mesh, axis, "max")
    corr = torch.exp(m - gm)
    l_g = collective.raw_all_reduce(l * corr, mesh, axis)
    acc_g = collective.raw_all_reduce(acc * corr[..., None], mesh, axis)
    out = acc_g / torch.clamp_min(l_g, 1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _write_owned(cache: torch.Tensor, new: torch.Tensor, idx: int,
                 r0: int) -> None:
    """Write positions [idx, idx + S) of ``new`` into the rows of the
    cache block that starts at global row ``r0`` and owns them."""
    lo = max(idx, r0)
    hi = min(idx + new.shape[1], r0 + cache.shape[1])
    if lo < hi:
        cache[:, lo - r0:hi - r0] = new[:, lo - idx:hi - idx].to(cache.dtype)


def attention(x: torch.Tensor, params: AttentionParams, *, num_heads: int,
              num_kv_heads: int, head_dim: int, positions: torch.Tensor,
              window: int = 0, causal: bool = True, qk_norm: bool = False,
              rope_theta: float = 10000.0, use_rope: bool = True,
              kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
              cache_index=None, compute_dtype=torch.bfloat16,
              block_kv: int = 1024, residual: torch.Tensor | None = None,
              page_table: torch.Tensor | None = None,
              cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full attention layer.  Returns (out, kv_cache | None).

    * prefill / training: kv from x; with a cache, written into it at
      ``cache_index`` (an int) and attended directly.
    * decode: ``kv_cache`` given, ``cache_index`` the (B,) per-row depths
      (``positions`` then (B, 1)) or an int; the new token's K/V are written
      into the cache IN PLACE (the reference returns an updated copy) and
      attention runs over the whole buffer.
    * paged decode: ``page_table`` (B, max_pages) given, ``kv_cache`` is the
      physical page pool (num_pages, page_size, KVH, D) shared by every
      slot.  The new K/V land at each slot's physical row and each slot's
      logical view is gathered out of the pool; the reserved null page 0
      absorbs inactive slots' writes and the per-row masks keep it out.
    * cross-attention: ``cross_kv`` the precomputed (B, S_enc, KVH, D) K /
      V of the encoder rows, attended whole (no rope, no qk-norm, no cache
      written).  The mask depends on those rows only, so it is built from
      1-D positions whatever the shape of ``positions``: a (B, 1) per-slot
      decode works.  (The reference passes the decoder's positions on, and
      with (B, 1) ones its mask gains an axis and the step raises.)
    * ``residual``: the block's residual stream, added in the
      out-projection's fused epilogue.
    """
    b, s, _ = x.shape
    q = dense(x, params.wq, compute_dtype).reshape(b, s, num_heads, head_dim)
    if cross_kv is not None:
        k, v = cross_kv
        out = blockwise_attention(
            q, k, v, q_positions=torch.arange(s, device=x.device),
            kv_positions=torch.arange(k.shape[1], device=x.device),
            window=0, causal=False, block_kv=block_kv)
        out = out.reshape(b, s, num_heads * head_dim)
        return dense(out, params.wo, compute_dtype, residual=residual), None
    k = dense(x, params.wk, compute_dtype).reshape(b, s, num_kv_heads, head_dim)
    v = dense(x, params.wv, compute_dtype).reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    if use_rope:
        pos2 = positions if positions.ndim == 2 else positions[None, :]
        q = rope(q, pos2, rope_theta)
        k = rope(k, pos2, rope_theta)
    if kv_cache is not None and page_table is not None:
        ck, cv = kv_cache                       # (num_pages, page, KVH, D)
        if s != 1:
            raise ValueError("paged attention is single-token decode")
        idx = torch.as_tensor(cache_index, device=x.device)
        nump, page = ck.shape[0], ck.shape[1]
        rows = torch.arange(b, device=x.device)
        phys = page_table[rows, idx // page] * page + idx % page
        flat_k = ck.view(nump * page, num_kv_heads, head_dim)
        flat_v = cv.view(nump * page, num_kv_heads, head_dim)
        flat_k[phys] = k[:, 0].to(flat_k.dtype)
        flat_v[phys] = v[:, 0].to(flat_v.dtype)

        def view(pool):
            return pool[page_table].reshape(b, -1, num_kv_heads, head_dim)

        out = decode_attention(q, view(ck), view(cv), q_pos=idx,
                               window=window)
        new_cache = (ck, cv)
    elif kv_cache is not None:
        ck, cv = kv_cache                       # (B, S_max, KVH, D)
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
            if s != 1:
                raise ValueError("per-row cache_index is single-token decode")
            rows = torch.arange(b, device=x.device)
            ck[rows, cache_index] = k[:, 0].to(ck.dtype)
            cv[rows, cache_index] = v[:, 0].to(cv.dtype)
            out = decode_attention(q, ck, cv, q_pos=cache_index,
                                   window=window)
        else:
            idx = int(cache_index)
            ctx = current_dist()
            sp = sp_decoding(ctx)
            if sp:
                r0 = ctx.mesh.axis_index(ctx.model_axis) * ck.shape[1]
                _write_owned(ck, k, idx, r0)
                _write_owned(cv, v, idx, r0)
            else:
                ck[:, idx:idx + s] = k.to(ck.dtype)
                cv[:, idx:idx + s] = v.to(cv.dtype)
            if s > 1:
                # Prefill from an empty cache: the fresh K/V span the whole
                # valid range, so attend over them directly.
                out = blockwise_attention(
                    q, k, v, q_positions=positions, kv_positions=positions,
                    window=window, causal=causal, block_kv=block_kv)
            elif sp:
                # K-parallel decode across ranks (paper Alg. 5).
                out = flash_decode(q, ck, cv, pos=idx + s - 1,
                                   window=window, dist=ctx)
            else:
                kv_pos = torch.arange(ck.shape[1], device=x.device)
                out = blockwise_attention(
                    q, ck, cv, q_positions=positions, kv_positions=kv_pos,
                    window=window, causal=causal, kv_valid_len=idx + s,
                    block_kv=block_kv)
        new_cache = (ck, cv)
    else:
        out = blockwise_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            window=window, causal=causal, block_kv=block_kv)
        new_cache = None
    out = out.reshape(b, s, num_heads * head_dim)
    return dense(out, params.wo, compute_dtype, residual=residual), new_cache
