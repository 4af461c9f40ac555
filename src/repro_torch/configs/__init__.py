"""Architecture registry of the port: the reference's ten configs."""
from . import (internvl2_2b, mistral_nemo_12b, olmoe_1b_7b, qwen2_7b,
               qwen2_moe_a2_7b, qwen3_8b, recurrentgemma_2b, rwkv6_7b,
               seamless_m4t_large_v2, smollm_135m)
from .base import LM_SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCHS", "LM_SHAPES", "ArchConfig", "ShapeSpec", "get"]

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    seamless_m4t_large_v2, mistral_nemo_12b, smollm_135m, qwen2_7b, qwen3_8b,
    olmoe_1b_7b, qwen2_moe_a2_7b, internvl2_2b, recurrentgemma_2b, rwkv6_7b)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
