"""qwen3-8b [dense]: GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    supports_long_context=False,   # pure full attention
    source="hf:Qwen/Qwen3-8B",
)
