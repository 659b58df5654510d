"""zamba2-7b [hybrid]: Mamba2 blocks + ONE shared attention+MLP block applied
every 6 SSM layers (single param set, faithful to Zamba2's shared-block
design). [arXiv:2411.15242; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_chunk=128, attn_every=6,
    supports_long_context=True,    # SSM + periodic attention
    source="arXiv:2411.15242",
)
