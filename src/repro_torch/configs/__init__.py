"""Architecture registry of the port (the configs whose families it runs)."""
from . import (mistral_nemo_12b, olmoe_1b_7b, qwen2_7b, qwen2_moe_a2_7b,
               qwen3_8b, recurrentgemma_2b, rwkv6_7b, smollm_135m)
from .base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    mistral_nemo_12b, smollm_135m, qwen2_7b, qwen3_8b, olmoe_1b_7b,
    qwen2_moe_a2_7b, recurrentgemma_2b, rwkv6_7b)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; have {sorted(ARCHS)}")
    return ARCHS[name]
