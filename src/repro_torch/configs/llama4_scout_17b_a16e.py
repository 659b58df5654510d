"""llama4-scout-17b-a16e [moe]: 16 experts top-1, 3:1 chunked-local:global
(iRoPE-style). Early-fusion modality frontend OUT of scope (stub).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=16, top_k=1,
    moe_dispatch="ragged",         # capacity-free: 16-way top-1 routing is
                                   # exactly the unbalanced regime where
                                   # static capacity drops or over-pads
    window_pattern=(-8192, -8192, -8192, 0),   # chunked local x3, global x1
    supports_long_context=True,    # chunked attention is sub-quadratic
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
