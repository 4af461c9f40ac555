"""Device dispatch for the WKV6 recurrence.

A tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
a CUDA device launches the hand-written kernel (``kernel``) or raises,
never falling back.  The kernel has no backward (nor has the
reference's), so on CUDA an input that needs a gradient raises.
"""
from __future__ import annotations

from . import kernel as K
from .ref import wkv6_ref


def wkv(r, k, v, logw, u, s0=None, chunk=64):
    """The chunked WKV6 of (B, T, H, N) inputs: returns ``(out, state)``;
    see :func:`ref.wkv6_ref`."""
    if r.device.type == "cuda":
        return K.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                      logw.contiguous(), u.contiguous(),
                      None if s0 is None else s0.contiguous(), chunk=chunk)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)
    raise ValueError(f"no WKV6 kernel for device {r.device}")
