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


def bf16_kernel_bound(q, k, v, ref, *, causal=True, window=None):
    """Per-element limit on ``|out - ref|`` for the bf16 kernel's ``out``
    against ``ref = attention_ref(q, k, v)`` in bf16, both (B, S, H, D).

    The kernel rounds each p to bf16 before ``p @ v``, which moves its f32
    output by at most ``u * sum(p |v|) / l`` (u = 2^-8, bf16's unit
    roundoff): ``u`` times the attention of ``|v|``.  Each side then rounds
    its f32 output to bf16 once, by at most ``u |out|``.  So ``|out - ref|
    <= 2u |ref| + u attention(|v|)``, to first order in u; the factor 1.01
    covers the second order and the f32 reorderings (about 1e-6 of
    attention(|v|))."""
    a = attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                      window=window)
    return 1.01 * (2.0 ** -7 * ref.float().abs() + 2.0 ** -8 * a)
