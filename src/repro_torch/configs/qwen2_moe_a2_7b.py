"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408
vocab=151936, 60 routed top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B].
Experts are padded 60 -> 64 for 16-way EP; padded experts router-masked."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, d_expert=1408, n_shared=4, qkv_bias=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; sub-quadratic required for 500k",
)
