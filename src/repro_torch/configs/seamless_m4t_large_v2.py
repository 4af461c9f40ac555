"""seamless-m4t-large-v2 [audio]: enc-dec multimodal backbone.

24L encoder + 24L decoder, d_model=1024, 16H (GQA kv=16), d_ff=8192,
vocab=256206 [arXiv:2308.11596; hf].  The speech/text frontend is a STUB:
``input_specs`` provides precomputed frame embeddings (B, S, d).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_dec_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=8192, vocab=256206, mlp_kind="gelu", norm_kind="layernorm",
    skip_shapes=("long_500k",),
    skip_reason="full-attention enc-dec: 500k dense decode cache is architecturally meaningless",
)
