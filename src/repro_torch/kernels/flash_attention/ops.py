"""Device dispatch for flash attention.

A tensor on the CPU takes the plain PyTorch version (``ref``), under
autograd as any PyTorch code; a tensor on a CUDA device launches the
hand-written kernels (``kernel``) or raises, never falling back.  On CUDA
an input that needs a gradient takes :class:`_Attention`: the bf16
forward that keeps each row's log-sum-exp, and the bf16 backward kernel.
The f32 kernel and head dims outside ``kernel.BWD_HEAD_DIMS`` are forward
only, and raise there.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .ref import attention_ref

# the reference wrapper's default key block, which decides T's alignment
_KV_BLOCK = 512


def aligned(t: int) -> bool:
    """Whether ``causal=False`` takes T keys: T aligned to the key block
    (``min(512, T)``), as in the reference's ``flash_attention``."""
    kb = min(_KV_BLOCK, t)
    return -(-t // kb) * kb == t


def attention(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, T, KV, D) -> (B, S, H, D), queries at
    positions 0..S-1 over keys at 0..T-1.  As in the reference's
    ``flash_attention``, ``causal=False`` needs T aligned to the key block
    (``min(512, T)``)."""
    if not causal and not aligned(k.shape[1]):
        raise ValueError("causal=False requires block-aligned T")
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            if q.dtype != torch.bfloat16 or q.shape[-1] not in \
                    K.BWD_HEAD_DIMS:
                raise RuntimeError(
                    f"flash_attention: the CUDA kernel is forward only for "
                    f"{q.dtype} at head_dim {q.shape[-1]} (the backward "
                    f"takes bf16 at {K.BWD_HEAD_DIMS}); call it without "
                    f"inputs that need a gradient")
            return _Attention.apply(q, k, v, causal, window)
        return K.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash attention kernel for device {q.device}")


class _Attention(torch.autograd.Function):
    """The kernels' forward and backward: the forward keeps q, k, v, its
    output and each row's log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = K.flash_attention(q, k, v, causal=causal, window=window,
                                     lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = K.flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None
