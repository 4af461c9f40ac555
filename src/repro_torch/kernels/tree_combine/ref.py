"""Plain PyTorch versions of the tree-combine and int8 wire-codec kernels.

They mirror the reference oracles (``repro/kernels/tree_combine/ref.py``)
operation for operation: the CPU path runs them, and the CUDA kernels are
held against them on the card.  The wire format is ``(..., m + 4) int8``:
m quantized lanes, then the f32 scale's four bytes in memory order.
"""
from __future__ import annotations

import torch

# a bitcast view needs a fresh buffer with standard strides
_DENSE = torch.contiguous_format


def tree_combine_ref(recv, partial):
    """partial + sum over children (dim 0 of ``recv``), accumulated in f32,
    returned in ``partial``'s dtype."""
    return (partial.float() + recv.float().sum(0)).to(partial.dtype)


def q8_scale(x, dim=None, keepdim=False):
    """The per-chunk f32 scale: max|x| maps to the top of the int8 range.
    The epsilon keeps |x|/scale strictly below 127.5 so the rounded
    quantizer never leaves [-127, 127].  Computed in ``x``'s dtype, then
    cast, as the reference does.  ``dim`` gives one scale per row."""
    a = x.abs()
    amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=keepdim)
    return (amax * (1.0 / 127.0) + 1e-30).float()


def _tail(scale):
    """The scale's bytes: ``(..., 1) f32 -> (..., 4) int8``."""
    return scale.clone(memory_format=_DENSE).view(torch.int8)


def _scale_of(wires):
    """The f32 scale carried in each wire's 4-byte tail: ``(..., 1)``."""
    return wires[..., -4:].clone(memory_format=_DENSE).view(torch.float32)


def q8_pack_ref(x, scale):
    """``(L,)`` float and a scalar f32 scale -> ``(L + 4,)`` int8 wire.
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    q = torch.round(x.float() * (1.0 / scale)).to(torch.int8)
    return torch.cat([q, _tail(scale.reshape(1))])


def q8_combine_ref(wire, partial):
    scale = _scale_of(wire)
    return (partial.float()
            + wire[:-4].float() * scale).to(partial.dtype)


def q8_unpack_ref(wire, dtype=torch.float32):
    return (wire[:-4].float() * _scale_of(wire)).to(dtype)


def q8_pack_rows_ref(x):
    """Row-batched pack: ``(R, m)`` float -> ``(R, m + 4)`` int8 wires with
    one scale per row."""
    scale = q8_scale(x, dim=1, keepdim=True)
    q = torch.round(x.float() * (1.0 / scale)).to(torch.int8)
    return torch.cat([q, _tail(scale)], dim=1)


def q8_combine_rows_ref(wires, partial):
    """``partial (R, m) + dequantize(wires (R, m + 4))`` row by row."""
    return (partial.float()
            + wires[:, :-4].float() * _scale_of(wires)).to(partial.dtype)


def q8_unpack_rows_ref(wires, dtype=torch.float32):
    """Inverse of :func:`q8_pack_rows_ref`: ``(R, m + 4)`` int8 -> ``(R, m)``."""
    return (wires[:, :-4].float() * _scale_of(wires)).to(dtype)
