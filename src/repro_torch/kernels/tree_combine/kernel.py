"""ctypes wrappers of the Hopper tree-combine and int8 wire-codec kernels
(``csrc/tree_combine.cu``).

The shared library is built by :mod:`repro_torch.kernels._build` at first
use (no fast math: the pack must stay byte-identical to the plain
version).  Nothing is built or loaded when this module is imported.

Every wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs (and the pack's scratch) with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch returns an error, and then adds one
to its entry in :data:`LAUNCHES`.  The CPU path never comes here: see
``ops``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_cuda, launched, stream

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIB = Library(Path(__file__).resolve().parent / "csrc" / "tree_combine.cu",
              "tree_combine", {
                  "tree_combine": [_i32, _p, _p, _p, _i64, _i64, _p],
                  "q8_pack_rows": [_p, _p, _p, _i64, _i64, _p],
                  "q8_combine_rows": [_p, _p, _p, _i64, _i64, _p],
                  "q8_unpack_rows": [_p, _p, _i64, _i64, _p]})

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"tree_combine": 0, "q8_pack_rows": 0, "q8_combine_rows": 0,
            "q8_unpack_rows": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_ROWS = 65535          # the row kernels put rows on gridDim.y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tree_combine(recv, partial):
    """``partial (L,) + recv (C, L).sum(0)``, f32 accumulation, output in
    ``partial``'s dtype (f32, bf16 or f16; ``recv`` of the same dtype)."""
    check_cuda("tree_combine", recv, partial)
    if recv.dim() != 2 or partial.dim() != 1 \
            or recv.shape[1] != partial.shape[0]:
        raise ValueError(f"tree_combine: recv (C, L) and partial (L,), got "
                         f"{tuple(recv.shape)} and {tuple(partial.shape)}")
    if partial.dtype not in _DTYPE_CODE or recv.dtype != partial.dtype:
        raise ValueError(f"tree_combine: f32/bf16/f16 of one dtype, got "
                         f"{recv.dtype} and {partial.dtype}")
    out = torch.empty_like(partial)
    with torch.cuda.device(partial.device):
        err = LIB.load().tree_combine(
            _DTYPE_CODE[partial.dtype], recv.data_ptr(), partial.data_ptr(),
            out.data_ptr(), recv.shape[0], partial.shape[0], stream(partial))
    launched(LAUNCHES, "tree_combine", err)
    return out


def _rows_check(name, x, dtype):
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (R, m), got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"{name}: at most {_MAX_ROWS} rows")


def q8_pack_rows(x):
    """``(R, m)`` f32 -> ``(R, m + 4)`` int8 wires, one scale per row."""
    check_cuda("q8_pack_rows", x)
    _rows_check("q8_pack_rows", x, torch.float32)
    r, m = x.shape
    wires = torch.empty((r, m + 4), dtype=torch.int8, device=x.device)
    amax = torch.empty((r,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = LIB.load().q8_pack_rows(x.data_ptr(), wires.data_ptr(),
                                      amax.data_ptr(), r, m, stream(x))
    launched(LAUNCHES, "q8_pack_rows", err)
    return wires


def q8_combine_rows(wires, partial):
    """``partial (R, m) + dequantize(wires (R, m + 4))``, f32."""
    check_cuda("q8_combine_rows", wires, partial)
    _rows_check("q8_combine_rows", wires, torch.int8)
    _rows_check("q8_combine_rows", partial, torch.float32)
    r, m = partial.shape
    if tuple(wires.shape) != (r, m + 4):
        raise ValueError(f"q8_combine_rows: wires {tuple(wires.shape)} do "
                         f"not match partial {(r, m)}")
    out = torch.empty_like(partial)
    with torch.cuda.device(partial.device):
        err = LIB.load().q8_combine_rows(
            wires.data_ptr(), partial.data_ptr(), out.data_ptr(), r, m,
            stream(partial))
    launched(LAUNCHES, "q8_combine_rows", err)
    return out


def q8_unpack_rows(wires):
    """``(R, m + 4)`` int8 wires -> ``(R, m)`` f32."""
    check_cuda("q8_unpack_rows", wires)
    _rows_check("q8_unpack_rows", wires, torch.int8)
    r, m4 = wires.shape
    if m4 < 4:
        raise ValueError("q8_unpack_rows: a wire holds at least its tail")
    out = torch.empty((r, m4 - 4), dtype=torch.float32, device=wires.device)
    with torch.cuda.device(wires.device):
        err = LIB.load().q8_unpack_rows(wires.data_ptr(), out.data_ptr(),
                                        r, m4 - 4, stream(wires))
    launched(LAUNCHES, "q8_unpack_rows", err)
    return out
