"""minitron-4b [dense]: pruned nemotron. [arXiv:2407.14679; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
    supports_long_context=False,   # pure full attention
    source="arXiv:2407.14679",
)
