"""Mamba2 blocks: SSD, the state-space duality (arXiv:2405.21060).

The layout is the reference's: d_inner = 2 * d_model, head dim P = 64,
one group (n_groups = 1), a depthwise causal conv of width 4 and a scalar
decay A per head.  The in-projection's width, 2 * d_inner + 2 * N + heads
(4384 for mamba2-370m, 14576 for zamba2-7b), is an irregular N that ends
in an edge tile of the ftIMM kernels.

Training and prefill run the chunked scan (chunk Q = ``ssm_chunk``): the
masked intra-chunk products and the inter-chunk state recurrence.  The
reference scans the chunks one by one (``lax.scan``); here the products of
``CHUNK_GROUP`` consecutive chunks run as one batch and only the state
update passes chunk to chunk, a Python loop (each chunk's values are the
one-by-one scan's; the batch bounds the op count of a long sequence, and
its memory at CHUNK_GROUP chunks' worth).  Decode is the O(1) recurrent
update of (h, conv).

The in / out projections go through ``layers.dense`` (``ftimm_gemm`` on
the card).  The SSD contractions are plain ``torch.matmul`` / ``einsum``:
the reference computes them with ``jnp.einsum`` outside any Pallas kernel.
The intra-chunk product is (C Bᵀ ⊙ decay) batched over (batch, head)
against x·dt, so no (B, Q, Q, H, P) tensor is ever formed.

Head sharding (``DistContext(ssm_head_shard=True)``, the reference's
``ssm.py:105-109``): a rank of the model axis (size tp) runs the scan on
its H / tp heads (``_heads``).  The in-projection's columns are
``[z | x | B | C | dt]``; the specs' model cut runs across that
concatenation (mamba2-370m's 4384 columns split at 2192, inside ``x``), so
the whole panel is read (gathered at use on a training mesh) and the rank
takes its heads' columns of z, x and dt and all of B and C (one group);
the conv taps the same channels.  The replicated leaves a rank reads in
part (the panel, the taps, conv_b, A_log, D_skip, dt_bias, the norm scale)
and the input go through ``collective.replicate``: the rank's gradient is
its part, summed over the axis.  The gated RMS norm spans every head: its
sum of squares is summed over the axis.  ``out_proj`` is a row panel
(``layers.row_parallel``), its rows this rank's heads, whole or cut.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dist import current_dist
from ..core.gemm import collective
from .attention import param
from .layers import column_input, dense, rms_norm, row_parallel

CONV_WIDTH = 4
HEADDIM = 64
CHUNK_GROUP = 16    # chunks whose intra-chunk products run as one batch
_MASKED = -1e30


def ssm_dims(d_model: int, ssm_state: int) -> tuple[int, int, int]:
    """(d_inner, heads, state width N)."""
    d_inner = 2 * d_model
    return d_inner, d_inner // HEADDIM, ssm_state


class SSMParams(nn.Module):
    """in_proj (D, 2·d_inner + 2N + H), conv_w (W, d_inner + 2N), conv_b,
    A_log / D_skip / dt_bias (H,), norm (d_inner,), out_proj (d_inner, D).
    A_log, D_skip, dt_bias and norm are fp32 in every model: the reference
    reads them as fp32 masters, and rounding them to bf16 would move the
    decay rates."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D_skip, dt_bias,
                 norm, out_proj, *, requires_grad: bool = False):
        super().__init__()
        self.in_proj = param(in_proj, requires_grad)
        self.conv_w = param(conv_w, requires_grad)
        self.conv_b = param(conv_b, requires_grad)
        self.A_log = param(A_log, requires_grad)
        self.D_skip = param(D_skip, requires_grad)
        self.dt_bias = param(dt_bias, requires_grad)
        self.norm = param(norm, requires_grad)
        self.out_proj = param(out_proj, requires_grad)


def init_ssm_params(gen: torch.Generator, d_model: int, ssm_state: int, *,
                    dtype: torch.dtype, device: torch.device,
                    requires_grad: bool = False) -> SSMParams:
    """The reference's initialisation, drawn from ``gen``: He-scaled normal
    projections, conv taps N(0, 0.25), A = 1..16 over the heads, D = 1,
    dt bias -2, zero norm scale and conv bias."""
    d_inner, nheads, n = ssm_dims(d_model, ssm_state)
    conv_ch = d_inner + 2 * n
    proj_out = 2 * d_inner + 2 * n + nheads

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    in_proj = normal((d_model, proj_out), (2.0 / d_model) ** 0.5)
    conv_w = normal((CONV_WIDTH, conv_ch), 0.5)
    out_proj = normal((d_inner, d_model), (2.0 / d_inner) ** 0.5)
    f32 = dict(dtype=torch.float32, device=device)
    return SSMParams(
        in_proj, conv_w, torch.zeros(conv_ch, dtype=dtype, device=device),
        torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        torch.ones(nheads, **f32), torch.full((nheads,), -2.0, **f32),
        torch.zeros(d_inner, **f32), out_proj, requires_grad=requires_grad)


def _heads(params: SSMParams, d_model: int, ssm_state: int):
    """The leaves as this rank's heads read them, the local d_inner and
    head count, and ``tp`` = (mesh, model axis) under head sharding (else
    None, and the leaves themselves)."""
    d_inner, nheads, n = ssm_dims(d_model, ssm_state)
    ctx = current_dist()
    names = ("in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
             "norm", "out_proj")
    view = SimpleNamespace(**{k: getattr(params, k) for k in names},
                           d_inner=d_inner, nheads=nheads, tp=None,
                           d_full=d_inner)
    if ctx is None or ctx.head_shard == 1:
        return view
    tp = (ctx.mesh, ctx.model_axis)
    nc, s = ctx.mesh.axis_size(ctx.model_axis), ctx.mesh.axis_index(
        ctx.model_axis)
    if nheads % nc:
        raise ValueError(f"{nheads} SSD heads do not divide over the {nc} "
                         "ranks of the model axis")
    h_l = nheads // nc
    di_l = h_l * HEADDIM
    dev = params.in_proj.device
    mine = torch.arange(s * di_l, (s + 1) * di_l, device=dev)
    bc = torch.arange(2 * n, device=dev)
    cols = torch.cat([mine, d_inner + mine, 2 * d_inner + bc,
                      2 * d_inner + 2 * n + torch.arange(
                          s * h_l, (s + 1) * h_l, device=dev)])
    chans = torch.cat([mine, d_inner + bc])

    def part(t, dim, idx):
        return collective.replicate(t, *tp).index_select(dim, idx)

    for name, full in (("in_proj", 2 * d_inner + 2 * n + nheads),
                       ("conv_w", d_inner + 2 * n)):
        if getattr(params, name).shape[1] != full:
            raise ValueError(f"head sharding reads {name} whole")
    heads = slice(s * h_l, (s + 1) * h_l)
    out = params.out_proj
    if out.shape[0] == d_inner:       # whole: this rank's heads' rows
        out = collective.shard(out, *tp, dim=0)
    return SimpleNamespace(
        in_proj=part(params.in_proj, 1, cols),
        conv_w=part(params.conv_w, 1, chans),
        conv_b=part(params.conv_b, 0, chans),
        A_log=collective.replicate(params.A_log, *tp)[heads],
        D_skip=collective.replicate(params.D_skip, *tp)[heads],
        dt_bias=collective.replicate(params.dt_bias, *tp)[heads],
        norm=collective.replicate(params.norm, *tp)[s * di_l:(s + 1) * di_l],
        out_proj=out, d_inner=di_l, nheads=h_l, tp=tp, d_full=d_inner)


def _gated_norm(y: torch.Tensor, v) -> torch.Tensor:
    """``rms_norm`` over the whole d_inner: under head sharding the sum of
    squares of this rank's channels summed over the model axis (its
    gradient too: each rank reads it for its own channels)."""
    if v.tp is None:
        return rms_norm(y, v.norm)
    yf = y.to(torch.float32)
    ss = collective.reduce_sum(torch.sum(torch.square(yf), dim=-1,
                                         keepdim=True), *v.tp)
    ss = collective.replicate(ss, *v.tp)
    out = yf * torch.rsqrt(ss / v.d_full + 1e-6) * (
        1.0 + v.norm.to(torch.float32))
    return out.to(y.dtype)


def _out(y: torch.Tensor, v, cdt) -> torch.Tensor:
    if v.tp is None:
        return dense(y, v.out_proj, cdt)
    return row_parallel(y, v.out_proj, v.tp, cdt)


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n: int):
    """z, x, B, C, dt along the last axis of the in-projection."""
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    b = zxbcdt[..., 2 * d_inner:2 * d_inner + n]
    c = zxbcdt[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, x, b, c, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``): ``F.softplus`` turns into the identity above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps w (W, C), then silu."""
    out = torch.zeros_like(x)
    for i in range(CONV_WIDTH):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted * w[CONV_WIDTH - 1 - i]
    return F.silu(out + b)


def _chunk_group(h, x_g, b_g, c_g, dt_g, a, causal):
    """A group of consecutive chunks of the scan, in fp32: (h (B, H, P, N)
    entering the first, the chunks' x (B, G, Q, H, P), B / C (B, G, Q, N),
    dt (B, G, Q, H)) -> (y (B, G, Q, H, P), h' after the last).  The
    intra-chunk products and each chunk's own state update run batched
    over the G chunks; the state passes chunk to chunk in order."""
    x_f, b_f, c_f = x_g.float(), b_g.float(), c_g.float()
    lcum = torch.cumsum(dt_g * a, dim=2)                      # (B, G, Q, H)
    # M[i, j] = exp(L_i - L_j) for j <= i.  Mask before the exp: j > i
    # has a positive difference that overflows, and the gradient of a
    # masked inf is NaN.
    diff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]    # (B,G,Q,Q,H)
    m = torch.exp(diff.masked_fill(~causal[None, None, :, :, None], _MASKED))
    cb = torch.matmul(c_f, b_f.transpose(2, 3))               # (B, G, Q, Q)
    xdt = x_f * dt_g[..., None]                               # (B,G,Q,H,P)
    # y_intra[b, g, i, h] = sum_j cb[b, g, i, j] m[b, g, i, j, h] xdt[...j, h]
    weights = (cb[..., None] * m).permute(0, 1, 4, 2, 3)      # (B,G,H,Q,Q)
    y_intra = torch.matmul(weights, xdt.transpose(2, 3))      # (B,G,H,Q,P)
    # each chunk's h' = exp(sum da) h + sum_j exp(L_Q - L_j) xdt_j b_j
    w = torch.exp(lcum[:, :, -1:, :] - lcum)                  # (B, G, Q, H)
    decay = torch.exp(lcum[:, :, -1, :])[..., None, None]     # (B,G,H,1,1)
    dh = torch.einsum("bgjhp,bgjn->bghpn", xdt * w[..., None], b_f)
    entering = []
    for decay_g, dh_g in zip(decay.unbind(1), dh.unbind(1)):
        entering.append(h)
        h = decay_g * h + dh_g
    # the carried state's share, decayed to each position
    y_inter = (torch.einsum("bgin,bghpn->bghip", c_f,
                            torch.stack(entering, dim=1))
               * torch.exp(lcum).transpose(2, 3)[..., None])
    return (y_intra + y_inter).transpose(2, 3), h


def ssd_forward(x: torch.Tensor, params: SSMParams, *, ssm_state: int,
                chunk: int = 256, compute_dtype=torch.bfloat16,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan over x (B, S, D).  Returns (y (B, S, D),
    final state (B, H, P, N) fp32).  The sequence is right-padded to whole
    chunks with dt = 0 (decay 1, no input), which leaves the state as the
    last real position left it."""
    cdt = compute_dtype
    bsz, s, d_model = x.shape
    v = _heads(params, d_model, ssm_state)
    d_inner, nheads, n = v.d_inner, v.nheads, ssm_state
    p = HEADDIM

    zxbcdt = dense(column_input(x, v.tp), v.in_proj, cdt)
    z, xs, b, c, dt = _split_proj(zxbcdt, d_inner, n)
    xbc = _causal_conv(torch.cat([xs, b, c], dim=-1), v.conv_w.to(cdt),
                       v.conv_b.to(cdt))
    xs = xbc[..., :d_inner].reshape(bsz, s, nheads, p)
    b = xbc[..., d_inner:d_inner + n]
    c = xbc[..., d_inner + n:]
    a = -torch.exp(v.A_log.float())                           # (H,)
    dt = _softplus(dt.float() + v.dt_bias.float())            # (B, S, H)

    pad = (-s) % chunk
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        b, c, dt = (F.pad(t, (0, 0, 0, pad)) for t in (b, c, dt))
    else:
        xs_p = xs
    h = (initial_state if initial_state is not None else torch.zeros(
        bsz, nheads, p, n, dtype=torch.float32, device=x.device))
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    nq = (s + pad) // chunk

    def chunks(t):
        return t.reshape((bsz, nq, chunk) + tuple(t.shape[2:]))

    xs_c, b_c, c_c, dt_c = (chunks(t) for t in (xs_p, b, c, dt))
    ys = []
    for g0 in range(0, nq, CHUNK_GROUP):
        g = slice(g0, g0 + CHUNK_GROUP)
        y_g, h = _chunk_group(h, xs_c[:, g], b_c[:, g], c_c[:, g],
                              dt_c[:, g], a, causal)
        ys.append(y_g)
    y = torch.cat(ys, dim=1).reshape(bsz, nq * chunk, nheads,
                                     p)[:, :s]               # fp32
    y = y + xs * v.D_skip.to(cdt)[None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(cdt)
    y = y * F.silu(z)
    y = _gated_norm(y, v)
    return _out(y, v, cdt), h


def conv_tail(x: torch.Tensor, params: SSMParams, *, ssm_state: int,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The conv state a prefill of x (B, S, D) leaves for decode: the conv
    inputs (the x, B and C channels of the in-projection) of the last
    CONV_WIDTH - 1 positions, re-projected, (B, W - 1, d_inner + 2N).  A
    prompt shorter than that is left-padded with zero rows, the causal
    conv's own padding (the reference leaves the missing rows as the cache
    held them)."""
    v = _heads(params, x.shape[-1], ssm_state)
    d_inner, n = v.d_inner, ssm_state
    tail = dense(x[:, -(CONV_WIDTH - 1):], v.in_proj, compute_dtype)
    xbc = tail[..., d_inner:2 * d_inner + 2 * n]
    short = CONV_WIDTH - 1 - xbc.shape[1]
    return F.pad(xbc, (0, 0, short, 0)) if short else xbc


def ssd_decode_step(x: torch.Tensor, params: SSMParams, state: dict, *,
                    ssm_state: int, compute_dtype=torch.bfloat16
                    ) -> tuple[torch.Tensor, dict]:
    """The O(1) recurrent step for x (B, 1, D) from ``state`` {"h": (B, H,
    P, N) fp32, "conv": (B, W - 1, C)}.  Returns (y (B, 1, D), the new
    state); ``state`` is not written."""
    cdt = compute_dtype
    bsz, _, d_model = x.shape
    v = _heads(params, d_model, ssm_state)
    d_inner, nheads, n = v.d_inner, v.nheads, ssm_state

    zxbcdt = dense(column_input(x[:, 0], v.tp), v.in_proj, cdt)
    z, xs, b, c, dt = _split_proj(zxbcdt, d_inner, n)
    xbc = torch.cat([xs, b, c], dim=-1)                       # (B, C)
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)   # (B, W, C)
    xbc_out = F.silu((window * v.conv_w.to(cdt)).sum(dim=1)
                     + v.conv_b.to(cdt))

    xs = xbc_out[:, :d_inner].reshape(bsz, nheads, HEADDIM)
    b = xbc_out[:, d_inner:d_inner + n].float()
    c = xbc_out[:, d_inner + n:].float()
    a = -torch.exp(v.A_log.float())
    dt = _softplus(dt.float() + v.dt_bias.float())            # (B, H)

    xdt = xs.float() * dt[..., None]                          # (B, H, P)
    h_new = (torch.exp(dt * a)[:, :, None, None] * state["h"]
             + xdt[..., None] * b[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_new, c)
    y = y + xs.float() * v.D_skip.float()[None, :, None]
    y = y.reshape(bsz, d_inner).to(cdt)
    y = y * F.silu(z)
    y = _gated_norm(y, v)
    out = _out(y, v, cdt)
    return out[:, None, :], {"h": h_new, "conv": window[:, 1:]}


def init_ssm_state(bsz: int, d_model: int, ssm_state: int, *,
                   dtype: torch.dtype, device: torch.device,
                   head_shard: int = 1) -> dict:
    """A zero state: h (B, H, P, N) fp32 and the conv window (B, W - 1,
    d_inner + 2N) in ``dtype``; ``head_shard`` tp: one rank's H / tp heads
    and their d_inner / tp channels of the window (``_heads``)."""
    d_inner, nheads, n = ssm_dims(d_model, ssm_state)
    if nheads % head_shard:
        raise ValueError(f"{nheads} SSD heads do not divide over "
                         f"{head_shard} ranks")
    nheads //= head_shard
    d_inner //= head_shard
    return {"h": torch.zeros(bsz, nheads, HEADDIM, n, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(bsz, CONV_WIDTH - 1, d_inner + 2 * n,
                                dtype=dtype, device=device)}
