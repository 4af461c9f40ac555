"""internvl2-2b [vlm]: InternViT frontend (STUB: patch embeddings) +
InternLM2 backbone 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92553,
    n_img_tokens=1024,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; sub-quadratic required for 500k",
)
