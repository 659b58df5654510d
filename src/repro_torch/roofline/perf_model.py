"""Analytic FLOP / device-memory-byte accounting per (arch x shape x step
kind), for the roofline of one H100.

FLOPs count every matmul of ``repro_torch.models`` (and the attention
products), and the elementwise work coarsely; bytes are the operand and
result streams of the major ops.  Train steps count exactly what the
reference's ``roofline/perf_model.py`` counts (its numbers, bucket by
bucket): forward, backward and the remat recompute, the optimizer.

Decode and prefill steps read each weight once.  The reference adds every
parameter as the ``weights`` bucket and also keeps the MLP, expert and SSM
projection panels in the per-layer ``mlp`` / ``moe_mlp`` / ``ssm_proj``
buckets, so it counts those panels twice (qwen3-1.7b, bf16, 4 sequences
over 80 cache rows: 5.598 GB a step, of which 2.115 GB are the MLP panels
again).  Here the per-layer buckets keep only their activation streams,
and ``weights`` prices each parameter once at the width the port serves
it in (the config's compute dtype), as often as the step reads it: a
capacity-free (ragged) MoE step reads the panels of only the min(E, t x
top_k) experts its t rows can reach, where capacity dispatch reads all E;
the hybrid reads its one shared block at each of its applications; an
encoder-decoder's decode step reads neither the encoder nor the cross K /
V projections.  Every other bucket equals the reference's.

All numbers are for the whole step: on one card, or summed over the
ranks of an expert-parallel mesh (``ep_shards``), whose token exchange is
the ``moe_a2a`` bucket's interconnect bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..configs.base import ModelConfig, ShapeConfig
from ..core.gemm.tuner import plan_moe_dispatch
from ..models.ssm import CONV_WIDTH, HEADDIM, ssm_dims

_WIDTH = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass
class Perf:
    flops: float = 0.0               # matmul (+ attention) flops
    bytes_hbm: float = 0.0           # device-memory traffic
    bytes_ici: float = 0.0           # cross-device traffic (moe_a2a)
    breakdown: dict = field(default_factory=dict)   # name -> [flops, hbm, ici]

    def add(self, name: str, flops: float = 0.0, byts: float = 0.0,
            ici: float = 0.0):
        self.flops += flops
        self.bytes_hbm += byts
        self.bytes_ici += ici
        d = self.breakdown.setdefault(name, [0.0, 0.0, 0.0])
        d[0] += flops
        d[1] += byts
        d[2] += ici


def _keff(s_q: int, kv_len: int, window: int, causal: bool,
          decode: bool) -> float:
    """Mean effective KV length per query under the window encoding."""
    if decode:
        full = kv_len
        if window > 0:
            return min(window, full)
        if window < 0:
            return min(-window, full)   # current chunk tail
        return full
    if not causal:
        return kv_len
    if window > 0:
        return min(window, (s_q + 1) / 2)
    if window < 0:
        return min(-window / 2, (s_q + 1) / 2)
    return (s_q + 1) / 2


def _attn(perf: Perf, cfg: ModelConfig, n_layers_by_window: dict[int, int],
          b: int, s_q: int, kv_len: int, *, causal=True, decode=False,
          cross=False, cdt=2):
    d, hd = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    t = b * s_q
    for window, n_l in n_layers_by_window.items():
        keff = _keff(s_q, kv_len, window, causal, decode)
        if not cross:
            proj_f = 2 * t * d * (nq * hd) + 2 * 2 * t * d * (nkv * hd)
        else:
            proj_f = 2 * t * d * (nq * hd)   # cross K/V projected separately
        proj_f += 2 * t * (nq * hd) * d      # output proj
        score_f = 2 * b * nq * hd * s_q * keff * 2   # qk^T and p@v
        byts = proj_f / (2 * d) * cdt * 2            # act streams in/out
        kv_bytes = 2 * b * min(keff * 2, kv_len) * nkv * hd * cdt
        perf.add("attn_proj", proj_f * n_l, byts * n_l)
        perf.add("attn_score", score_f * n_l, kv_bytes * n_l)


def _mlp(perf: Perf, cfg: ModelConfig, n_l: int, t: int, cdt=2,
         panels: bool = True, ep_shards: int = 1):
    """``panels``: the bucket also streams its weight panels (train).
    ``ep_shards`` > 1: the experts are cut over that many ranks, and the
    planner's expert-parallel placement prices the token exchange (both
    legs) in the ``moe_a2a`` bucket -- interconnect bytes, kept out of the
    device-memory totals."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.num_experts:
        perf.add("router", 2 * t * d * cfg.num_experts * n_l,
                 t * d * cdt * n_l)
        # The dispatch buffer's rows from the planner the GEMM stack
        # plans with: E x capacity for "capacity", T x top_k for "ragged".
        mp = plan_moe_dispatch(
            t, cfg.num_experts, cfg.top_k, d, f, dispatch=cfg.moe_dispatch,
            capacity_factor=cfg.capacity_factor, elt_bytes=cdt,
            num_shards=ep_shards)
        rows = mp.rows
        weights = 3 * d * f * cdt * cfg.num_experts if panels else 0
        perf.add("moe_mlp", 6 * rows * d * f * n_l,
                 (2 * rows * d * cdt + weights) * n_l)
        if mp.placement is not None:
            perf.add("moe_a2a", ici=mp.placement.link_bytes * n_l)
    else:
        weights = 3 * d * f * cdt if panels else 0
        perf.add("mlp", 6 * t * d * f * n_l,
                 (2 * t * d * cdt + weights) * n_l)


def _ssm(perf: Perf, cfg: ModelConfig, n_l: int, b: int, s: int,
         decode: bool, cdt=2, panels: bool = True):
    d = cfg.d_model
    di, hh, n = ssm_dims(d, cfg.ssm_state)
    p = HEADDIM
    t = b * s
    proj_out = 2 * di + 2 * n + hh
    weights = (d * proj_out + di * d) * 4 if panels else 0
    perf.add("ssm_proj", (2 * t * d * proj_out + 2 * t * di * d) * n_l,
             (2 * t * d * cdt + weights) * n_l)
    perf.add("ssm_conv", 2 * t * CONV_WIDTH * (di + 2 * n) * n_l,
             t * (di + 2 * n) * cdt * n_l)
    if decode:
        # h' = decay h + x (x) b ; y = C.h : ~4 flops per state element
        perf.add("ssm_state", 4 * t * hh * p * n * n_l,
                 2 * t * hh * p * n * 4 * n_l)   # state read+write f32
    else:
        q = cfg.ssm_chunk
        intra = 2 * t * q * n + 2 * t * q * hh * p   # cb + y_intra
        inter = 3 * 2 * t * hh * p * n               # y_inter/state upd/decay
        perf.add("ssm_ssd", (intra + inter) * n_l,
                 (t * hh * p * cdt * 3) * n_l)


def forward_perf(cfg: ModelConfig, b: int, s: int, kind: str,
                 ep_shards: int = 1) -> Perf:
    """kind: train | prefill | decode (decode: s = cache length, one new
    token).  Train counts the weight panels in the per-layer buckets, as
    the reference does; decode and prefill leave them to ``step_perf``'s
    ``weights`` bucket.  ``ep_shards`` > 1 prices the MoE layers expert
    parallel (the ``moe_a2a`` bucket): pass the size of the mesh axes that
    hold the experts; 1 keeps every expert on each rank."""
    perf = Perf()
    decode = kind == "decode"
    panels = kind == "train"
    t = b * (1 if decode else s)
    s_q = 1 if decode else s
    kv_len = s
    cdt = 2

    wins: dict[int, int] = {}
    for w in cfg.windows():
        wins[w] = wins.get(w, 0) + 1

    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "encdec"):
        if fam == "vlm" and not decode:
            s_q = s + cfg.num_patches
            t = b * s_q
            kv_len = s_q
        _attn(perf, cfg, wins, b, s_q, kv_len, decode=decode, cdt=cdt)
        _mlp(perf, cfg, cfg.num_layers, t, cdt, panels, ep_shards)
        if fam == "encdec":
            se = cfg.encoder_seq
            te = b * se
            if not decode:
                # encoder runs at train/prefill only (cross-KV then cached)
                _attn(perf, cfg, {0: cfg.encoder_layers}, b, se, se,
                      causal=False, cdt=cdt)
                _mlp(perf, cfg, cfg.encoder_layers, te, cdt, panels)
                perf.add("frame_proj", 2 * te * cfg.d_model ** 2)
                perf.add("cross_kv", 2 * te * cfg.d_model
                         * (2 * cfg.num_kv_heads * cfg.head_dim_)
                         * cfg.num_layers)
            _attn(perf, cfg, {0: cfg.num_layers}, b, s_q, se,
                  causal=False, decode=decode, cross=True, cdt=cdt)
    elif fam == "ssm":
        _ssm(perf, cfg, cfg.num_layers, b, 1 if decode else s, decode, cdt,
             panels)
    elif fam == "hybrid":
        _ssm(perf, cfg, cfg.num_layers, b, 1 if decode else s, decode, cdt,
             panels)
        g = cfg.num_layers // cfg.attn_every
        _attn(perf, cfg, {0: g}, b, s_q, kv_len, decode=decode, cdt=cdt)
        _mlp(perf, cfg, g, t, cdt, panels, ep_shards)
    if cfg.num_patches and not decode:
        perf.add("patch_proj", 2 * b * cfg.num_patches * cfg.d_model ** 2)

    # coarse elementwise terms (norms/residuals/rope/softmax)
    n_l = cfg.num_layers
    perf.add("elementwise", 25.0 * t * cfg.d_model * n_l)
    if cfg.num_heads:
        for window, nw in wins.items():
            keff = _keff(s_q, kv_len, window, True, decode)
            perf.add("elementwise",
                     6.0 * b * cfg.num_heads * s_q * keff * nw)
    if fam in ("ssm", "hybrid"):
        perf.add("elementwise",
                 4.0 * b * (1 if decode else s) * cfg.ssm_chunk
                 * (2 * cfg.d_model // 64) * n_l)

    # unembed: all positions for train, last position otherwise
    t_logits = t if kind == "train" else b
    perf.add("unembed", 2 * t_logits * cfg.d_model * cfg.vocab_padded,
             t_logits * cfg.vocab_padded * 4)
    perf.add("embed", 0.0, t * cfg.d_model * cdt)
    return perf


def served_width(cfg: ModelConfig) -> int:
    """Bytes of one parameter as the port serves it: the compute dtype
    (``models.model.init_params`` without a master dtype)."""
    return _WIDTH[cfg.compute_dtype]


def experts_reached(cfg: ModelConfig, tokens: int) -> int:
    """Expert panels one MoE layer reads for ``tokens`` rows: min(E, t x
    top_k) under ragged dispatch, all E under capacity dispatch."""
    if cfg.moe_dispatch == "ragged":
        return min(cfg.num_experts, tokens * max(cfg.top_k, 1))
    return cfg.num_experts


def weight_bytes(cfg: ModelConfig, tokens: int, kind: str) -> float:
    """The ``weights`` bucket of a decode or prefill step of ``tokens``
    rows: each parameter the step reads, once per read, at
    ``served_width``.  A ragged MoE layer's experts count only as far as
    its rows reach; the hybrid's shared block counts once for each of its
    num_layers // attn_every applications; an encoder-decoder's decode
    step reads neither the encoder nor the cross K / V projections, whose
    output its prefill cached."""
    n = cfg.param_count()
    d, hd = cfg.d_model, cfg.head_dim_
    n_q, n_kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    block = d * (n_q + 2 * n_kv) + n_q * d + 3 * d * cfg.d_ff
    if cfg.num_experts:
        panel = 3 * cfg.d_model * cfg.d_ff
        n -= (cfg.num_layers * panel
              * (cfg.num_experts - experts_reached(cfg, tokens)))
    if cfg.family == "hybrid" and cfg.attn_every:
        n += (cfg.num_layers // cfg.attn_every - 1) * block
    if cfg.family == "encdec" and kind == "decode":
        n -= cfg.encoder_layers * block + cfg.num_layers * 2 * d * n_kv
    return float(n * served_width(cfg))


def step_perf(cfg: ModelConfig, shape: ShapeConfig,
              ep_shards: int = 1) -> Perf:
    """Whole-step perf: training includes the backward, the remat recompute
    and the optimizer (the reference's accounting); decode and prefill are
    forward-only, their weights priced as the step reads them
    (``weight_bytes``).  ``ep_shards`` as in ``forward_perf``; a train
    step's multiplier acts on ``moe_a2a`` as on every bucket (the backward
    runs its own two legs, the remat recompute the forward's again)."""
    kind = shape.kind
    fwd = forward_perf(cfg, shape.global_batch, shape.seq_len, kind,
                       ep_shards)
    if kind != "train":
        tokens = shape.global_batch * (1 if kind == "decode"
                                       else shape.seq_len)
        fwd.add("weights", 0.0, weight_bytes(cfg, tokens, kind))
        if kind == "decode":
            # cache READS are counted per layer in attn_score / ssm_state;
            # this bucket is the one-token cache WRITE only
            fwd.add("kv_cache_write", 0.0,
                    _cache_bytes(cfg, shape) / max(shape.seq_len, 1))
        return fwd
    mult = {"none": 3.0, "dots": 3.4, "full": 4.0}[cfg.remat]
    inner_ckpt = {"attn_score", "ssm_ssd"}   # checkpointed inner scans
    out = Perf()
    for k, (f, by, ici) in fwd.breakdown.items():
        m = mult + 1.0 if k in inner_ckpt else mult
        out.add(k, f * m, by * (m - 1.0), ici * (m - 1.0))
    n_params = cfg.param_count()
    # params read fwd+bwd, grads written+read, adam m/v read+write, p write
    out.add("weights_opt", 10.0 * n_params, 12.0 * n_params * 4)
    # layer residual checkpoints: save + 2 reads, bf16
    t = shape.tokens
    out.add("residual_ckpt", 0.0, 3.0 * cfg.num_layers * t * cfg.d_model * 2)
    return out


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    b, s = shape.global_batch, shape.seq_len
    kvh, hd = cfg.num_kv_heads, cfg.head_dim_
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        c = 2 * cfg.num_layers * b * s * kvh * hd * 2
        if cfg.family == "encdec":
            c += 2 * cfg.num_layers * b * cfg.encoder_seq * kvh * hd * 2
        return c
    di, hh, n = ssm_dims(cfg.d_model, cfg.ssm_state)
    ssm = cfg.num_layers * b * (hh * HEADDIM * n * 4
                                + (CONV_WIDTH - 1) * (di + 2 * n) * 2)
    if cfg.family == "hybrid":
        g = cfg.num_layers // cfg.attn_every
        ssm += 2 * g * b * s * kvh * hd * 2
    return ssm
