"""Architecture registry of the port (the configs whose families it runs)."""
from . import recurrentgemma_2b, rwkv6_7b, smollm_135m
from .base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (smollm_135m, recurrentgemma_2b,
                                           rwkv6_7b)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; have {sorted(ARCHS)}")
    return ARCHS[name]
