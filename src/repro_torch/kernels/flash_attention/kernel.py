"""ctypes wrapper of the Hopper flash attention forward kernel
(``csrc/flash_attention.cu``).

The shared library is built by :mod:`repro_torch.kernels._build` at first
use; nothing is built or loaded when this module is imported.  The
wrapper takes CUDA tensors only, checks them, allocates its output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch returns an error, and then adds one
to :data:`LAUNCHES`.  The CPU path never comes here: see ``ops``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import Library, check_cuda, launched, stream

_p, _i32 = ctypes.c_void_p, ctypes.c_int
LIB = Library(Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
              "flash_attention", {"flash_attention": [
                  _i32, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _i32,
                  _i32, _i32, ctypes.c_float, _p]})

#: launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)      # the kernel's template instances
_MAX_GRID_Y = 65535                 # batch * kv heads is gridDim.y
_ALIGN = 16                         # bytes: the kernels load 16 at once


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, T, KV, D), H a multiple of KV, one dtype
    (f32 or bf16), D in :data:`HEAD_DIMS`.  Returns (B, S, H, D) in q's
    dtype; queries at positions 0..S-1, keys at 0..T-1."""
    check_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,S,H,D), k and v (B,T,KV,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: f32 or bf16 of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if t < 1 or b * kv > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: needs T >= 1 and B * KV <= "
                         f"{_MAX_GRID_Y}, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if any(x.data_ptr() % _ALIGN for x in (q, k, v)):
        raise ValueError(f"flash_attention: q, k and v must start on "
                         f"{_ALIGN}-byte boundaries")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = LIB.load().flash_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, t, h, kv, d, int(causal),
            0 if window is None else int(window),
            1.0 / math.sqrt(d), stream(q))
    launched(LAUNCHES, "flash_attention", err)
    return out
