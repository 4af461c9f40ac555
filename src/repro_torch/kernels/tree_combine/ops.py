"""Device dispatch for the tree-combine and int8 wire-codec kernels.

A tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
a CUDA device launches the hand-written kernel (``kernel``) or raises,
never falling back.  Unlike the reference there is no cap on the buffer
size: the CUDA kernels take any length.

On CUDA the codec kernels take and return f32 (the gradient dtype of the
training path); the combine takes f32, bf16 or f16.
"""
from __future__ import annotations

import torch

from . import kernel as K
from .ref import (q8_combine_ref, q8_combine_rows_ref, q8_pack_ref,
                  q8_pack_rows_ref, q8_scale, q8_unpack_ref,
                  q8_unpack_rows_ref, tree_combine_ref)


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no tree-combine kernel for device {t.device}")


def _f32_out(dtype, name):
    if dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA codec decodes to float32 only, "
                         f"got {dtype}")


def combine(recv, partial):
    """``partial (L,) + recv (C, L).sum(0)`` with f32 accumulation."""
    if _on_cuda(partial):
        return K.tree_combine(recv, partial)
    return tree_combine_ref(recv, partial)


def q8_pack(x):
    """Quantize ``(L,)`` into the ``(L + 4,)`` int8 wire (lanes + scale)."""
    if _on_cuda(x):
        return K.q8_pack_rows(x[None])[0]
    return q8_pack_ref(x, q8_scale(x))


def q8_combine(wire, partial):
    """``partial + dequantize(wire)``: the quantize-aware tree combine."""
    if _on_cuda(partial):
        return K.q8_combine_rows(wire[None], partial[None])[0]
    return q8_combine_ref(wire, partial)


def q8_unpack(wire, dtype=torch.float32):
    """Dequantize an ``(L + 4,)`` wire back to ``(L,)`` of ``dtype``."""
    if _on_cuda(wire):
        _f32_out(dtype, "q8_unpack")
        return K.q8_unpack_rows(wire[None])[0]
    return q8_unpack_ref(wire, dtype)


def q8_pack_rows(x):
    """Pack every row at once: ``(R, m) -> (R, m + 4)`` int8 wires."""
    if _on_cuda(x):
        return K.q8_pack_rows(x)
    return q8_pack_rows_ref(x)


def q8_combine_rows(wires, partial):
    """Row form of :func:`q8_combine`: ``(R, m + 4)`` wires onto ``(R, m)``."""
    if _on_cuda(partial):
        return K.q8_combine_rows(wires, partial)
    return q8_combine_rows_ref(wires, partial)


def q8_unpack_rows(wires, dtype=torch.float32):
    """Inverse of :func:`q8_pack_rows`: ``(R, m + 4)`` int8 -> ``(R, m)``."""
    if _on_cuda(wires):
        _f32_out(dtype, "q8_unpack_rows")
        return K.q8_unpack_rows(wires)
    return q8_unpack_rows_ref(wires, dtype)
