"""Build and load the port's CUDA kernel libraries.

Each library is one CUDA C++ source with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` (no fast math: the kernels match their plain
versions rounding for rounding where they can) into ``build/kernels/`` at
the repository root, or ``$REPRO_TORCH_BUILD_DIR``, under a name keyed by
the hash of the source and the flags, so a stale build is never loaded.
It is loaded with ``ctypes``.  Nothing is built or loaded when a module
is imported: :meth:`Library.load` builds at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's kernels "
                       "are built from source at first use")


class Library:
    """One shared library: ``source`` built into ``lib<name>-<hash>.so``,
    its C functions bound with ``signatures`` (``{fn: [argtypes]}``, every
    function returning the ``int`` of ``cudaGetLastError()``)."""

    def __init__(self, source: Path, name: str, signatures: dict):
        self.source, self.name, self.signatures = source, name, signatures
        #: what the last build reported: ``{"path", "seconds", "log"}``
        #: (``log`` holds ptxas' register, shared-memory and spill lines)
        self.info: dict = {}
        self._lib = None

    def build(self) -> Path:
        """Compile once per source hash; return the library's path."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
        out = build_dir() / f"lib{self.name}-{digest}.so"
        if out.exists():
            self.info.setdefault("path", str(out))
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(self.source)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        self.info.update(path=str(out), seconds=time.perf_counter() - t0,
                         log=(res.stdout + res.stderr).strip())
        return out

    def load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Run every library's ``nvcc`` at once (one process per source)."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        list(pool.map(Library.build, libraries))


def check_cuda(name, *tensors) -> None:
    """CUDA tensors only, contiguous, all on one device."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensors only, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def stream(t) -> int:
    """PyTorch's current stream on ``t``'s device, as ctypes takes it."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def launched(counts: dict, name: str, err: int) -> None:
    """Raise on a launch error, else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    counts[name] += 1
