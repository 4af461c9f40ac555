"""ctypes wrapper of the Hopper WKV6 kernel (``csrc/wkv6.cu``).

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
LIB = Library(Path(__file__).resolve().parent / "csrc" / "wkv6.cu", "wkv6",
              {"wkv6": [ctypes.c_int] + [_p] * 8 + [_i64] * 5 + [_p]})

#: launches since the last :func:`reset_launches`
LAUNCHES = {"wkv6": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64          # the head size and the chunk fit one 64 x 64 tile
MAX_CHUNK = 64
_MAX_GRID = 2 ** 31 - 1   # batch * heads is gridDim.x


def reset_launches() -> None:
    LAUNCHES["wkv6"] = 0


def wkv6(r, k, v, logw, u, s0=None, chunk=64):
    """r, k, v: (B, T, H, N) of one dtype (f32 or bf16); logw: (B, T, H, N)
    f32; u: (H, N) f32; s0: (B, H, N, N) f32 or None (zeros); N and chunk
    at most 64.  Returns ``(out (B, T, H, N) in r's dtype, state (B, H, N,
    N) f32)``."""
    opt = () if s0 is None else (s0,)
    check_cuda("wkv6", r, k, v, logw, u, *opt)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (r, k, v, logw, u) + opt):
        raise RuntimeError("wkv6: the CUDA kernel is forward only; call it "
                           "without inputs that need a gradient")
    if r.dim() != 4 or not r.shape == k.shape == v.shape == logw.shape:
        raise ValueError(f"wkv6: r, k, v and logw of one (B, T, H, N) shape, "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    b, t, h, n = r.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"wkv6: head size N must be 1..{MAX_N}, got {n}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6: chunk must be 1..{MAX_CHUNK}, got {chunk}")
    if t < 1 or b * h > _MAX_GRID:
        raise ValueError(f"wkv6: needs T >= 1 and B * H <= {_MAX_GRID}, "
                         f"got {tuple(r.shape)}")
    if tuple(u.shape) != (h, n):
        raise ValueError(f"wkv6: u must be {(h, n)}, got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (b, h, n, n):
        raise ValueError(f"wkv6: s0 must be {(b, h, n, n)}, got "
                         f"{tuple(s0.shape)}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v f32 or bf16 of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    for x in (logw, u) + opt:
        if x.dtype != torch.float32:
            raise ValueError(f"wkv6: logw, u and s0 float32 only, got "
                             f"{x.dtype}")
    out = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = LIB.load().wkv6(
            _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            logw.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), out.data_ptr(),
            s_fin.data_ptr(), b, t, h, n, min(chunk, t), stream(r))
    launched(LAUNCHES, "wkv6", err)
    return out, s_fin
