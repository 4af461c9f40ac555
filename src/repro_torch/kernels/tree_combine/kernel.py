"""ctypes wrappers of the Hopper tree-combine and int8 wire-codec kernels
(``csrc/tree_combine.cu``).

The shared library is built from the source in this package at first use
(``nvcc`` for ``sm_90a``, no fast math: the pack must stay byte-identical
to the plain version) into ``build/kernels/`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``, under a name keyed by the source's and flags'
hash, so a stale build is never loaded.  Nothing is built or loaded when
this module is imported.

Every wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs (and the pack's scratch) with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises if the launch returns an error, and then adds one
to its entry in :data:`LAUNCHES`.  The CPU path never comes here: see
``ops``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "tree_combine.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"tree_combine": 0, "q8_pack_rows": 0, "q8_combine_rows": 0,
            "q8_unpack_rows": 0}

#: what the last build reported: ``{"path", "seconds", "log"}`` (``log``
#: holds ptxas' register and shared-memory lines)
BUILD_INFO: dict = {}

_LIB = None
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_ROWS = 65535          # the row kernels put rows on gridDim.y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[4] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the tree-combine "
                       "kernels are built from source at first use")


def build() -> Path:
    """Compile the kernels into a shared library (once per source hash)
    and return its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = build_dir() / f"libtree_combine-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault("path", str(out))
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{res.stdout}"
                           f"\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=(res.stdout + res.stderr).strip())
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.tree_combine.argtypes = [i32, p, p, p, i64, i64, p]
        lib.q8_pack_rows.argtypes = [p, p, p, i64, i64, p]
        lib.q8_combine_rows.argtypes = [p, p, p, i64, i64, p]
        lib.q8_unpack_rows.argtypes = [p, p, i64, i64, p]
        for fn in (lib.tree_combine, lib.q8_pack_rows, lib.q8_combine_rows,
                   lib.q8_unpack_rows):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _check(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensors only, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _done(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def tree_combine(recv, partial):
    """``partial (L,) + recv (C, L).sum(0)``, f32 accumulation, output in
    ``partial``'s dtype (f32, bf16 or f16; ``recv`` of the same dtype)."""
    _check("tree_combine", recv, partial)
    if recv.dim() != 2 or partial.dim() != 1 \
            or recv.shape[1] != partial.shape[0]:
        raise ValueError(f"tree_combine: recv (C, L) and partial (L,), got "
                         f"{tuple(recv.shape)} and {tuple(partial.shape)}")
    if partial.dtype not in _DTYPE_CODE or recv.dtype != partial.dtype:
        raise ValueError(f"tree_combine: f32/bf16/f16 of one dtype, got "
                         f"{recv.dtype} and {partial.dtype}")
    out = torch.empty_like(partial)
    with torch.cuda.device(partial.device):
        err = _lib().tree_combine(_DTYPE_CODE[partial.dtype], recv.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(),
                                  recv.shape[0], partial.shape[0],
                                  _stream(partial))
    _done("tree_combine", err)
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
    _check("q8_pack_rows", x)
    _rows_check("q8_pack_rows", x, torch.float32)
    r, m = x.shape
    wires = torch.empty((r, m + 4), dtype=torch.int8, device=x.device)
    amax = torch.empty((r,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().q8_pack_rows(x.data_ptr(), wires.data_ptr(),
                                  amax.data_ptr(), r, m, _stream(x))
    _done("q8_pack_rows", err)
    return wires


def q8_combine_rows(wires, partial):
    """``partial (R, m) + dequantize(wires (R, m + 4))``, f32."""
    _check("q8_combine_rows", wires, partial)
    _rows_check("q8_combine_rows", wires, torch.int8)
    _rows_check("q8_combine_rows", partial, torch.float32)
    r, m = partial.shape
    if tuple(wires.shape) != (r, m + 4):
        raise ValueError(f"q8_combine_rows: wires {tuple(wires.shape)} do "
                         f"not match partial {(r, m)}")
    out = torch.empty_like(partial)
    with torch.cuda.device(partial.device):
        err = _lib().q8_combine_rows(wires.data_ptr(), partial.data_ptr(),
                                     out.data_ptr(), r, m, _stream(partial))
    _done("q8_combine_rows", err)
    return out


def q8_unpack_rows(wires):
    """``(R, m + 4)`` int8 wires -> ``(R, m)`` f32."""
    _check("q8_unpack_rows", wires)
    _rows_check("q8_unpack_rows", wires, torch.int8)
    r, m4 = wires.shape
    if m4 < 4:
        raise ValueError("q8_unpack_rows: a wire holds at least its tail")
    out = torch.empty((r, m4 - 4), dtype=torch.float32, device=wires.device)
    with torch.cuda.device(wires.device):
        err = _lib().q8_unpack_rows(wires.data_ptr(), out.data_ptr(), r,
                                    m4 - 4, _stream(wires))
    _done("q8_unpack_rows", err)
    return out
