"""gemma3-4b [dense]: 5:1 local(1024):global attention, qk_norm, 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144, qk_norm=True, rope_theta=1e6,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    supports_long_context=True,    # 5:1 sliding-window:global
    source="hf:google/gemma-3-1b-pt",
)
