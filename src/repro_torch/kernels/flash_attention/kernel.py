"""ctypes wrappers of the Hopper flash attention kernels
(``csrc/flash_attention.cu``): the forward, optionally with each row's
log-sum-exp, and the bf16 backward.

The shared library is built by :mod:`repro_torch.kernels._build` at first
use; nothing is built or loaded when this module is imported.  The
wrapper takes CUDA tensors only, checks them, allocates its outputs (and
the backward's scratch) with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises if the launch returns an
error, and then adds one to its key of :data:`LAUNCHES`.  The CPU path never comes here: see ``ops``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import Library, check_cuda, launched, stream

_p, _i32 = ctypes.c_void_p, ctypes.c_int
LIB = Library(Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
              "flash_attention", {
                  "flash_attention": [
                      _i32, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32,
                      _i32, _i32, _i32, ctypes.c_float, _p],
                  "flash_attention_bwd": [
                      _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i32, _i32,
                      _i32, _i32, _i32, _i32, _i32, _i32, ctypes.c_float,
                      _p]})

#: launches since the last :func:`reset_launches`: the forward without
#: and with the log-sum-exp, and the backward (its three kernels count
#: once); and, not a launch, the training attention calls on a CUDA device
#: that ``models/layers.py::attention`` left on the blockwise ``sdpa``
LAUNCHES = {"flash_attention": 0, "flash_attention_lse": 0,
            "flash_attention_bwd": 0, "attention_sdpa_train": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)      # the forward's template instances
BWD_HEAD_DIMS = (32, 64, 128)       # the backward's (bf16 only)
_MAX_GRID_Y = 65535                 # batch * kv heads is gridDim.y
_ALIGN = 16                         # bytes: the kernels load 16 at once


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(q, k, v, *, causal=True, window=None, lse=False):
    """q: (B, S, H, D); k, v: (B, T, KV, D), H a multiple of KV, one dtype
    (f32 or bf16), D in :data:`HEAD_DIMS`.  Returns (B, S, H, D) in q's
    dtype; queries at positions 0..S-1, keys at 0..T-1.  With ``lse``
    (bf16 only) returns ``(out, lse)``, lse f32 (B, KV, S, H / KV): query
    s of head ``kv * G + g``'s log-sum-exp of its scaled, masked scores at
    ``lse[b, kv, s, g]``, which the backward takes."""
    _check(q, k, v)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if lse and q.dtype != torch.bfloat16:
        raise ValueError("flash_attention: the log-sum-exp comes from the "
                         "bf16 kernel only")
    out = torch.empty_like(q)
    rows = torch.empty((b, kv, s, h // kv), dtype=torch.float32,
                       device=q.device) if lse else None
    with torch.cuda.device(q.device):
        err = LIB.load().flash_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if rows is None else rows.data_ptr(), b, s,
            t, h, kv, d, int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d), stream(q))
    launched(LAUNCHES, "flash_attention_lse" if lse else "flash_attention",
             err)
    return (out, rows) if lse else out


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True,
                        window=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention`'s ``out``
    for the gradient ``dout`` of it: q, out, dout (B, S, H, D); k, v
    (B, T, KV, D), all bf16, D in :data:`BWD_HEAD_DIMS`; lse as the forward
    with ``lse=True`` returned it for these q, k, v, causal and window.
    The same inputs give the same bits."""
    _check(q, k, v)
    check_cuda("flash_attention_bwd", q, out, dout, lse)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: bf16 with head_dim in "
                         f"{BWD_HEAD_DIMS}, got {q.dtype}, {d}")
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: out and dout must be q's "
                         f"shape {tuple(q.shape)} and dtype")
    if lse.shape != (b, kv, s, h // kv) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse f32 {(b, kv, s, h // kv)}"
                         f", got {lse.dtype} {tuple(lse.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window {window} < 1")
    if any(x.data_ptr() % _ALIGN for x in (out, dout)):
        raise ValueError(f"flash_attention_bwd: out and dout must start on "
                         f"{_ALIGN}-byte boundaries")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    dd = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = LIB.load().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, t, h, kv, d, int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(d),
            stream(q))
    launched(LAUNCHES, "flash_attention_bwd", err)
    return dq, dk, dv


def _check(q, k, v):
    """What both directions take of q, k and v."""
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
    if any(x.data_ptr() % _ALIGN for x in (q, k, v)):
        raise ValueError(f"flash_attention: q, k and v must start on "
                         f"{_ALIGN}-byte boundaries")
