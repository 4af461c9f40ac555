"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm [hf:Qwen/Qwen3-8B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="lm",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; sub-quadratic required for 500k",
)
