"""Architecture config schema (copied from the JAX package's configs/base.py).

One frozen dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM
stacks; family-specific fields are zero/empty when unused.  Attention
patterns are encoded per layer as ints (see models.attention): >0 sliding
window, 0 global, <0 chunked local of size |w| — cycled over layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


def ceil_to(x: int, b: int) -> int:
    return -(-x // b) * b


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attn-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    window_pattern: tuple[int, ...] = (0,)
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "capacity"   # "capacity" (drop+pad) | "ragged" (keep all)
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: shared attn after every N ssm layers
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub frontend)
    # --- VLM (llava) ---
    num_patches: int = 0             # precomputed patch embeddings (stub frontend)
    # --- numerics / memory ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    quant: str = "none"              # core.quant mode for MLP/expert panels
                                     # ("w8"/"w4"/"int8"/...); ragged MoE +
                                     # dense MLP down projections
    vocab_pad_multiple: int = 16
    remat: str = "full"              # none | full | dots
    scan_unroll: bool = False        # unroll all scans (FLOPs probes only)
    # long-context applicability (DESIGN.md §Arch-applicability)
    supports_long_context: bool = False
    source: str = ""

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return ceil_to(self.vocab_size, self.vocab_pad_multiple)

    def windows(self) -> tuple[int, ...]:
        pat = self.window_pattern or (0,)
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd = self.head_dim_
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        attn = d * (n_q + 2 * n_kv) + n_q * d
        mlp = 3 * d * f
        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            per_layer = attn + mlp
        elif self.family == "moe":
            per_layer = attn + self.num_experts * mlp + d * self.num_experts
        elif self.family in ("ssm", "hybrid"):
            d_inner = 2 * d
            nheads = d_inner // 64
            proj = d * (2 * d_inner + 2 * self.ssm_state + nheads)
            per_layer = proj + d_inner * d
        total = self.num_layers * per_layer + v * d
        if self.family == "hybrid" and self.attn_every:
            total += attn + mlp   # one shared attention+mlp block
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp)   # encoder stack
            total += self.num_layers * (attn)             # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.family != "moe" or not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd = self.head_dim_
        attn = d * (self.num_heads + 2 * self.num_kv_heads) * hd \
            + self.num_heads * hd * d
        mlp = 3 * d * f
        per_layer = attn + self.top_k * mlp + d * self.num_experts
        return int(self.num_layers * per_layer + self.vocab_padded * d)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=2 if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_chunk=32,
        attn_every=2 if cfg.attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16),
        num_patches=min(cfg.num_patches, 8),
        window_pattern=tuple(min(w, 16) if w > 0 else max(w, -16)
                             for w in cfg.window_pattern),
        remat="none",
    )
