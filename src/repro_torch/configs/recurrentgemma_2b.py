"""recurrentgemma-2b [hybrid]: 26L d_model=2560, RG-LRU + local attention
1:2 (pattern rec,rec,attn), 10H (MQA kv=1, head_dim 256), d_ff=7680 (GeGLU),
vocab=256000, window 2048 [arXiv:2402.19427].

The serve-time attention blocks (``serve_q_block``, ``serve_kv_block``) are
the reference's values, kept so that the configs stay equal; they size the
reference's blockwise attention, and the CUDA kernel picks its own tiles."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="rglru",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, head_dim=256,
    d_ff=7680, vocab=256000, mlp_kind="geglu", window=2048,
    lru_width=2560, pattern=("rec", "rec", "attn"), conv_width=4,
    serve_q_block=2_048, serve_kv_block=2_048,
)
