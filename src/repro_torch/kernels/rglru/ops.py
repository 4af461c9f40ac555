"""Device dispatch for the RG-LRU scan.

A tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
a CUDA device launches the hand-written kernel (``kernel``) or raises,
never falling back.  The scan takes and returns f32, the dtype the
recurrentgemma model runs it in.
"""
from __future__ import annotations

from . import kernel as K
from .ref import rglru_ref


def lru_scan(a, bx, h0=None):
    """``h_t = a_t * h_{t-1} + bx_t`` over axis 1: returns ``(h, h_last)``."""
    if a.device.type == "cuda":
        return K.rglru_scan(a.contiguous(), bx.contiguous(),
                            None if h0 is None else h0.contiguous())
    if a.device.type == "cpu":
        return rglru_ref(a, bx, h0)
    raise ValueError(f"no RG-LRU scan kernel for device {a.device}")
