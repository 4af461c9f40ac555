"""ctypes wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru.cu``).

The shared library is built by :mod:`repro_torch.kernels._build` at first
use; nothing is built or loaded when this module is imported.  The
wrapper takes CUDA tensors only, checks them, allocates its outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch returns an error, and then adds one
to :data:`LAUNCHES`.  The CPU path never comes here: see ``ops``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_cuda, launched, stream

_p, _i64 = ctypes.c_void_p, ctypes.c_int64
LIB = Library(Path(__file__).resolve().parent / "csrc" / "rglru.cu",
              "rglru", {"rglru_scan": [_p, _p, _p, _p, _p, _i64, _i64, _i64,
                                       _p]})

#: launches since the last :func:`reset_launches`
LAUNCHES = {"rglru_scan": 0}

_MAX_BATCH = 65535         # the batch is gridDim.y


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def rglru_scan(a, bx, h0=None):
    """a, bx: (B, T, W) f32; h0: (B, W) f32 or None (zeros).  Returns
    ``(h (B, T, W), h_last (B, W))``, both f32."""
    check_cuda("rglru_scan", a, bx, *(() if h0 is None else (h0,)))
    if a.dim() != 3 or bx.shape != a.shape:
        raise ValueError(f"rglru_scan: a and bx of one (B, T, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    b, t, w = a.shape
    if h0 is not None and tuple(h0.shape) != (b, w):
        raise ValueError(f"rglru_scan: h0 must be {(b, w)}, got "
                         f"{tuple(h0.shape)}")
    for x in (a, bx) + (() if h0 is None else (h0,)):
        if x.dtype != torch.float32:
            raise ValueError(f"rglru_scan: float32 only, got {x.dtype}")
    if b > _MAX_BATCH:
        raise ValueError(f"rglru_scan: at most {_MAX_BATCH} batch rows")
    h = torch.empty_like(a)
    h_last = torch.empty((b, w), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = LIB.load().rglru_scan(
            a.data_ptr(), bx.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr(), b, t, w, stream(a))
    launched(LAUNCHES, "rglru_scan", err)
    return h, h_last
