"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=131072, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="lm",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; sub-quadratic required for 500k",
)
