"""whisper-base [audio]: enc-dec, conv frontend STUBBED (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    encoder_layers=6, encoder_seq=1500,
    supports_long_context=False,   # enc-dec, full attention, 448-token decoder
    source="arXiv:2212.04356",
)
