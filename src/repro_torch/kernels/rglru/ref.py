"""Plain PyTorch version of the RG-LRU scan kernel.

The function of the reference's ``repro/kernels/rglru`` (kernel and
oracle): ``h_t = a_t * h_{t-1} + b_t`` over time, elementwise over the
width.  The reference's oracle evaluates it as an associative scan; this
version is the sequential loop, in f32, which the CUDA kernel repeats
multiply for multiply and add for add.
"""
from __future__ import annotations

import torch


def rglru_ref(a, bx, h0=None):
    """a, bx: (B, T, W) f32; h0: (B, W) f32 or None (zeros).  Returns
    ``(h (B, T, W), h_last (B, W))``, both f32."""
    b, t, w = a.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=a.device) \
        if h0 is None else h0
    out = torch.empty_like(a)
    for i in range(t):
        h = a[:, i] * h + bx[:, i]
        out[:, i] = h
    return out, h
