"""rwkv6-7b [ssm]: Finch, attention-free, 32L d_model=4096 d_ff=14336
vocab=65536, head_size 64 (data-dependent decay) [arXiv:2404.05892].
State recurrence: runs long_500k."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336, vocab=65536,
    head_size=64,
)
