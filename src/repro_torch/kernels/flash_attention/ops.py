"""Device dispatch for flash attention.

A tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
a CUDA device launches the hand-written forward kernel (``kernel``) or
raises, never falling back.  The kernel has no backward (nor has the
reference's), so on CUDA an input that needs a gradient raises.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .ref import attention_ref

# the reference wrapper's default key block, which decides T's alignment
_KV_BLOCK = 512


def attention(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D), queries at
    positions 0..S-1 over keys at 0..T-1.  As in the reference's
    ``flash_attention``, ``causal=False`` needs T aligned to the key block
    (``min(512, T)``)."""
    t = k.shape[1]
    kb = min(_KV_BLOCK, t)
    if not causal and -(-t // kb) * kb != t:
        raise ValueError("causal=False requires block-aligned T")
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            raise RuntimeError("flash_attention: the CUDA kernel is forward "
                               "only; call it without inputs that need a "
                               "gradient")
        return K.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal,
                                 window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash attention kernel for device {q.device}")
