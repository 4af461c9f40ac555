"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, d_expert=1024, moe_renorm=False, qk_norm=True,
    # GShard dispatch cost ~ G*E*C*d with C ~ G*k/E: smaller groups cut the
    # dispatch einsums 2x (frac +7%, compute term -35%; EXPERIMENTS follow-ups)
    moe_group_size=256,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; sub-quadratic required for 500k",
)
