"""seamless-m4t-large-v2 [audio] — enc-dec backbone; frame-embedding stub.

[arXiv:2308.11596; hf]  24L encoder + 24L decoder, d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  The speech frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings [B, S, 1024].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    frontend="frame_stub",
    activation="gelu",
)
