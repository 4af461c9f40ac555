"""Plain PyTorch version of the flash attention kernel: the function of the
reference's oracle ``repro/kernels/flash_attention/ref.py::attention_ref``.

Scores, the ``-1e30`` mask, the softmax and ``p @ v`` are f32 whatever
the input dtype; the output is in q's dtype.  Quadratic memory: the CPU
path runs it, and the CUDA kernel is held against it on the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D).  Query s sees
    key t when ``t <= s`` (causal) and ``t > s - window`` (window)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    tpos = torch.arange(s, device=q.device)[:, None]
    spos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (spos <= tpos)
    if window is not None:
        mask = mask & (spos > tpos - window)
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
