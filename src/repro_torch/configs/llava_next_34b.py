"""llava-next-34b [vlm]: dense LM backbone; anyres tiling / vision tower
STUBBED (input_specs provides precomputed patch embeddings, 576 = one
336px ViT-L/14 tile). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    num_patches=576,
    supports_long_context=False,   # pure full attention
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
