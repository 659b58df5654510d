"""Top-level model API of every family -- dense, MoE, SSM, hybrid,
encoder-decoder (encdec) and vision-language (vlm): init / training
forward and loss / encode / prefill / bucketed prefill / decode, and the
cache.

Batch dict convention, as in the reference: ``tokens`` (B, S) int, and for
training ``labels`` (B, S) int and ``loss_mask`` (B, S) float; the stub
frontends' precomputed embeddings ``frames`` (B, S_enc, D) (encdec: audio
frames; the conv frontend is out of scope) and ``patch_embeds`` (B, P, D)
(vlm: one tile's patches; the vision tower is out of scope).  The
parameters are one ``DenseLM`` module (the reference's parameter pytree):
the (V_pad, D) embedding table, shared by the embed and the unembed, the
fp32 final-norm scale, one block per layer -- a ``DenseBlock``, whose
feed-forward is a SwiGLU MLP (dense, encdec, vlm) or routed experts (moe),
or an ``SSMBlock`` (ssm, hybrid) -- and, for the hybrid, the one
``shared_attn`` ``DenseBlock`` applied after every ``attn_every`` layers.
The encdec model adds the (D, D) ``frame_proj``, the ``encoder`` blocks and
the fp32 ``enc_norm``, and its decoder blocks carry cross-attention; the
vlm model adds the (D, D) ``patch_proj``, whose patch rows are prepended
to the token embeddings (the logits cover the text positions only, and the
caches hold ``num_patches`` more rows).
A serving model holds its weights in the compute dtype and no gradient; a
training model holds fp32 masters (``cfg.param_dtype``) that require grad,
cast at use.  Norm scales and the SSM's A_log / D_skip / dt_bias stay
fp32 in both.

In the capacity-dispatch MoE, every token of a stack pass is routed and
takes capacity, the right-padding of a bucket prefill and the idle slots of
a decode step included -- as in the reference.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..core.dist import current_dist
from ..launch.sharding import shard_block
from .attention import param, sp_decoding
from .layers import dense, embed, rms_norm, unembed
from .transformer import (RECURRENT_FAMILIES, DenseBlock, SSMBlock, as_dtype,
                          check_family, compute_dtype, init_cache,
                          init_dense_block, init_ssm_block, stack_cached,
                          stack_train)

__all__ = ["DenseLM", "init_params", "forward_train", "loss_fn", "prefill",
           "prefill_bucket", "decode_step", "make_cache", "encode"]


class DenseLM(nn.Module):
    def __init__(self, embed_table: torch.Tensor, final_norm: torch.Tensor,
                 layers: list[DenseBlock] | list[SSMBlock], *,
                 shared_attn: DenseBlock | None = None,
                 encoder: list[DenseBlock] | None = None,
                 enc_norm: torch.Tensor | None = None,
                 frame_proj: torch.Tensor | None = None,
                 patch_proj: torch.Tensor | None = None,
                 requires_grad: bool = False):
        super().__init__()
        self.embed = param(embed_table, requires_grad)
        self.final_norm = param(final_norm, requires_grad)
        self.layers = nn.ModuleList(layers)
        self.shared_attn = shared_attn
        self.encoder = None if encoder is None else nn.ModuleList(encoder)
        for name, t in (("enc_norm", enc_norm), ("frame_proj", frame_proj),
                        ("patch_proj", patch_proj)):
            setattr(self, name, None if t is None else param(t, requires_grad))


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device | None = None,
                dtype: str | torch.dtype | None = None,
                dist=None) -> DenseLM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, with
    the reference's distributions (embedding N(0, 0.02^2), He-scaled
    projections, router and experts, the frame and patch projections, zero
    norm scales; the SSM's as ``ssm.init_ssm_params``).  Runs on the CUDA
    card unless ``device`` says otherwise; raises when no card is present
    and no device is given.

    ``dtype=None`` (serving) keeps the weights in the compute dtype, with no
    gradient.  A ``dtype`` asks for training masters (``cfg.param_dtype``):
    the weights in that dtype, requiring grad, cast to the compute dtype at
    use.  Norm scales are fp32 either way.

    ``dist`` (a ``core.dist.DistContext``): this rank's serving state, each
    block cut by ``launch.sharding.shard_block`` as soon as it is drawn --
    the draws are the one-device model's, bitwise, and a rank never holds
    more than one layer's other experts at a time."""
    check_family(cfg)
    device = resolve_device(device)
    train = dtype is not None
    dt = as_dtype(dtype) if train else compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    table = (torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen,
                         device=device) * 0.02).to(dt)
    encdec = cfg.family == "encdec"
    block = (init_ssm_block if cfg.family in RECURRENT_FAMILIES
             else functools.partial(init_dense_block, cross=encdec))
    layers = []
    for _ in range(cfg.num_layers):
        layers.append(block(gen, cfg, device, dt, train))
        if dist is not None:
            shard_block(layers[-1], dist)
    extra = {}
    if cfg.family == "hybrid":
        extra["shared_attn"] = init_dense_block(gen, cfg, device, dt, train)
    if encdec:
        extra["encoder"] = [init_dense_block(gen, cfg, device, dt, train)
                            for _ in range(cfg.encoder_layers)]
        extra["enc_norm"] = torch.zeros(cfg.d_model, device=device)
    d = cfg.d_model
    for name, wanted in (("patch_proj", cfg.num_patches),
                         ("frame_proj", cfg.encoder_seq)):
        if wanted:
            extra[name] = (torch.randn((d, d), generator=gen, device=device)
                           * (2.0 / d) ** 0.5).to(dt)
    return DenseLM(table, torch.zeros(d, device=device), layers,
                   requires_grad=train, **extra)


def _embed_inputs(model: DenseLM, cfg: ModelConfig, batch: dict):
    """Token embeddings, after the projected patch rows when the batch
    has ``patch_embeds`` (vlm), and their positions."""
    cdt = compute_dtype(cfg)
    h = embed(batch["tokens"], model.embed, cdt)
    if cfg.num_patches and "patch_embeds" in batch:
        patches = dense(batch["patch_embeds"].to(cdt), model.patch_proj, cdt)
        h = torch.cat([patches, h], dim=1)
    return h, torch.arange(h.shape[1], device=h.device)


def encode(model: DenseLM, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """The encoder stack over precomputed frame embeddings (B, S_enc, D):
    ``frame_proj``, the non-causal dense blocks (rope over the frame
    positions), ``enc_norm``."""
    cdt = compute_dtype(cfg)
    h = dense(frames.to(cdt), model.frame_proj, cdt)
    h, _ = stack_train(model.encoder, cfg, h,
                       torch.arange(h.shape[1], device=h.device),
                       causal=False)
    return rms_norm(h, model.enc_norm)


def _cross_kv_stack(model: DenseLM, cfg: ModelConfig,
                    enc_out: torch.Tensor) -> list:
    """Each decoder layer's cross (K, V), (B, S_enc, KVH, D) each, from the
    encoder output: one ``dense`` a layer for K and one for V, computed once
    per forward or prefill."""
    cdt = compute_dtype(cfg)
    b, s, _ = enc_out.shape
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim_)
    return [(dense(enc_out, p.cross.wk, cdt).reshape(shape),
             dense(enc_out, p.cross.wv, cdt).reshape(shape))
            for p in model.layers]


def forward_train(model: DenseLM, cfg: ModelConfig,
                  batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence fp32 logits for training.  -> (logits (B, S, V_pad),
    aux loss); for vlm over the text positions only."""
    h, positions = _embed_inputs(model, cfg, batch)
    cross = None
    if cfg.family == "encdec":
        cross = _cross_kv_stack(model, cfg,
                                encode(model, cfg, batch["frames"]))
    h, aux = stack_train(model.layers, cfg, h, positions,
                         shared=model.shared_attn, cross_kv_stack=cross)
    h = rms_norm(h, model.final_norm)
    if cfg.num_patches:
        h = h[:, cfg.num_patches:]
    logits = unembed(h, model.embed, cfg.vocab_size, compute_dtype(cfg))
    return logits, aux


def loss_fn(model: DenseLM, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Masked next-token cross entropy over fp32 logits (logsumexp minus
    the label's logit), plus ``aux_weight`` x the MoE aux loss.  -> (total,
    {"loss": ce, "aux_loss": aux, "tokens": mask sum})."""
    logits, aux = forward_train(model, cfg, batch)
    labels = batch["labels"].to(torch.long)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    nll = lse - picked
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    total = ce + aux_weight * aux
    return total, {"loss": ce, "aux_loss": aux, "tokens": mask.sum()}


def make_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device: torch.device) -> dict:
    """KV cache sized for ``max_len`` positions (vlm: and the
    ``num_patches`` patch rows in front of them; encdec: and the encoder
    rows' cross K / V), or the SSM state (and the hybrid's shared-block KV)
    of ``batch_size`` rows.  Under a ``DistContext`` that decodes
    sequence-parallel (``attention.sp_decoding``), a dense, moe or vlm
    model's K / V caches hold this rank's block of the positions, S / nc
    rows (the model axis size must divide S); the other families' caches
    stay whole (the SSM head cut is not ported: ROADMAP Queue 1 item 10)."""
    rows = max_len + (cfg.num_patches or 0)
    ctx = current_dist()
    if sp_decoding(ctx) and cfg.family in ("dense", "moe", "vlm"):
        nc = ctx.model_size
        if rows % nc:
            raise ValueError(f"a {rows}-row cache does not divide over the "
                             f"{nc} ranks of the model axis")
        rows //= nc
    return init_cache(cfg, batch_size, rows, device)


@torch.no_grad()
def prefill(model: DenseLM, cfg: ModelConfig, batch: dict,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the stack, filling ``cache`` in place (the
    encdec model first encodes ``batch["frames"]`` and writes every layer's
    cross K / V).  Returns (last-position logits (B, V), cache)."""
    h, positions = _embed_inputs(model, cfg, batch)
    if cfg.family == "encdec":
        cross = _cross_kv_stack(model, cfg,
                                encode(model, cfg, batch["frames"]))
        for layer, (k, v) in enumerate(cross):
            cache["cross_k"][layer].copy_(k)
            cache["cross_v"][layer].copy_(v)
    h, cache = stack_cached(model.layers, cfg, h, positions, cache, 0,
                            shared=model.shared_attn)
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
    lens[r].  Returns ((B, V) logits, cache).  Attention-cache families
    only: pad tokens would run through a recurrent state (and the encdec
    model, as the reference's).  A vlm row's last position is
    lens[r] - 1 + num_patches."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"bucketed prefill unsupported for {cfg.family}")
    h, positions = _embed_inputs(model, cfg, batch)
    h, cache = stack_cached(model.layers, cfg, h, positions, cache, 0)
    idx = (lens.to(device=h.device, dtype=torch.long) - 1
           + (cfg.num_patches or 0))
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
    already in the cache (vlm: the patch rows included), an int or a (B,)
    vector of per-slot depths (slots at mixed depths in one step, each
    writing and masking at its own row).
    ``page_table`` (B, max_pages): ``cache`` holds paged pools shared by
    every slot (``serve.kv_pages``; attention families only).  The SSM
    families advance every row's state one token whatever its ``pos``.
    Returns (logits (B, V), cache)."""
    h = embed(tokens, model.embed, compute_dtype(cfg))
    if isinstance(pos, torch.Tensor) and pos.ndim:
        pos = pos.to(device=h.device, dtype=torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.arange(pos, pos + 1, device=h.device)
    h, cache = stack_cached(model.layers, cfg, h, positions, cache, pos,
                            shared=model.shared_attn, page_table=page_table)
    h = rms_norm(h, model.final_norm)
    logits = unembed(h, model.embed, cfg.vocab_size, compute_dtype(cfg))
    return logits[:, 0], cache
