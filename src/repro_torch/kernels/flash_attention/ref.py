"""Plain PyTorch version of the flash attention kernel: the function of the
reference's oracle ``repro/kernels/flash_attention/ref.py::attention_ref``.

Scores, the ``-1e30`` mask, the softmax and ``p @ v`` are f32 whatever
the input dtype; the output is in q's dtype.  Quadratic memory: the CPU
path runs it, and the CUDA kernel is held against it on the card.
:func:`attention_ref_lse` also returns each row's log-sum-exp, and
:func:`attention_bwd_ref` is the backward kernel's arithmetic
(FlashAttention-2's) in f32.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D).  Query s sees
    key t when ``t <= s`` (causal) and ``t > s - window`` (window)."""
    return attention_ref_lse(q, k, v, causal=causal, window=window)[0]


def _logits(q, k, causal, window):
    """f32 scaled scores (B, KV, G, S, T), ``-1e30`` where masked, and the
    mask (S, T)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    tpos = torch.arange(s, device=q.device)[:, None]
    spos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (spos <= tpos)
    if window is not None:
        mask = mask & (spos > tpos - window)
    return torch.where(mask, logits, -1e30), mask


def attention_ref_lse(q, k, v, *, causal=True, window=None):
    """:func:`attention_ref` and each row's log-sum-exp of its scaled,
    masked scores: ``(out, lse)``, lse f32 (B, KV, S, G) with query s of
    head ``kv * G + g`` at ``[b, kv, s, g]`` (the kernel's layout)."""
    b, s, h, d = q.shape
    logits, _ = _logits(q, k, causal, window)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    lse = torch.logsumexp(logits, dim=-1).permute(0, 1, 3, 2)
    return out.reshape(b, s, h, d).to(q.dtype), lse.contiguous()


def attention_bwd_ref(q, k, v, out, dout, lse, *, causal=True, window=None):
    """The gradients ``(dq, dk, dv)``, f32, of ``out = attention(q, k, v)``
    for ``dout``, by FlashAttention-2's formulas as the backward kernel
    computes them, in f32: D = rowsum(dout o out); p = exp(s / sqrt(d) -
    lse), masked p 0; dv = p^T dout; dp = dout v^T; ds = p o (dp - D);
    dq = ds k / sqrt(d); dk = ds^T q / sqrt(d).  Shapes as
    :func:`attention_ref_lse`'s inputs and outputs."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    logits, mask = _logits(q, k, causal, window)
    p = torch.where(mask, torch.exp(
        logits - lse.permute(0, 1, 3, 2)[..., None]), 0.0)
    qg = q.reshape(b, s, kv, g, d).float()
    dg = dout.reshape(b, s, kv, g, d).float()
    dd = (dg * out.reshape(b, s, kv, g, d).float()).sum(-1)   # (b,s,kv,g)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dg)
    dp = torch.einsum("bskgd,btkd->bkgst", dg, v.float())
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) / math.sqrt(d)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) / math.sqrt(d)
    return dq.reshape(b, s, h, d), dk, dv


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


def bf16_bwd_bound(q, k, v, out, dout, lse, ref, *, causal=True,
                   window=None):
    """Per-element limits ``[bq, bk, bv]`` on ``|grad - ref|`` for the bf16
    backward kernel's dq, dk and dv against ``ref =
    attention_bwd_ref(q, k, v, out, dout, lse)`` on the same bf16 inputs.

    The kernel rounds p to bf16 as the operand of p^T dO, and dS as the
    operand of dS K and dS^T q, each by at most ``u |x|`` (u = 2^-8); so dv
    moves by at most ``u |p|^T |dO|``, dq by ``u |dS| |k| / sqrt(d)`` and
    dk by ``u |dS|^T |q| / sqrt(d)``.  dS = p (dP - D) itself differs by
    the f32 sums of dP and D taken in other orders on the two sides, at
    most ``2 d 2^-24 p (|dO| |v|^T + rowsum(|dO| |O|))`` (which matters
    where dP - D cancels, as in a row that sees one key, where dS is 0).
    Each result is then rounded to bf16 once, by at most ``u`` of itself.
    The factor 1.02 covers the second order and the f32 sums of the
    products in other orders."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    u = 2.0 ** -8
    logits, mask = _logits(q, k, causal, window)
    p = torch.where(mask, torch.exp(
        logits - lse.permute(0, 1, 3, 2)[..., None]), 0.0)
    del logits
    dg = dout.reshape(b, s, kv, g, d).float()
    og = out.reshape(b, s, kv, g, d).float()
    dd = (dg * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    dd_abs = (dg.abs() * og.abs()).sum(-1).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bskgd,btkd->bkgst", dg, v.float())
    w = u * (p * (dp - dd)).abs()
    dp = torch.einsum("bskgd,btkd->bkgst", dg.abs(), v.float().abs())
    w += (2 * d * 2.0 ** -24) * p * (dp + dd_abs)
    del dp
    av = u * torch.einsum("bkgst,bskgd->btkd", p, dg.abs())
    del p
    aq = torch.einsum("bkgst,btkd->bskgd", w, k.float().abs()) \
        .reshape(b, s, h, d) / math.sqrt(d)
    ak = torch.einsum("bkgst,bskgd->btkd", w, q.reshape(
        b, s, kv, g, d).float().abs()) / math.sqrt(d)
    return [1.02 * (u * r.float().abs() + a)
            for r, a in zip(ref, (aq, ak, av))]
