"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="lm",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536, vocab=49152,
    serve_q_block=16_384, serve_kv_block=16_384,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; sub-quadratic required for 500k",
)
