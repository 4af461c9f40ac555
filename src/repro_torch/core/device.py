"""The torch device an entry point runs on."""
from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card raises instead
    of moving the run to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return dev
