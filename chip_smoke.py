#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's four kernel libraries (tree-combine / int8 wire codec,
flash attention, RG-LRU scan, WKV6) from the sources in this checkout,
one ``nvcc`` per source, all at once; holds each kernel against its plain
PyTorch version at ragged small shapes and at every shape its path gives
it, and times it (flash attention in bf16, on the tensor cores, at both
prefill shapes, and in f32, on the CUDA cores, at recurrentgemma-2b's;
beside SDPA, and at smollm-135m's also SDPA's is_causal form); sums a
full-size stacked gradient with every EDST engine (per-tree, fused,
pipelined at 1 and 4 segments, striped; 4x4 torus f32 and int8, ring 16
int8); trains the full-width smollm-135m data-parallel over the 16
vertices of the 4x4 torus (edst with each engine, edst + int8 wire,
psum_dp, and one profiled edst step whose trace it splits into the
sync's waves) and of the ring 16 (edst + int8 wire, the fabric whose
reduce hops run q8_combine); and serves three full-width models through
the serving entry point, bf16, 32 greedy tokens each: recurrentgemma-2b
(batch 8, prompt 4096), smollm-135m (batch 8, prompt 1024) and rwkv6-7b
(batch 8, prompt 4096), each followed by an f32 check that a decode
step's logits equal those of a prefill of the same tokens.  Beside
WKV6's row it logs where the kernel's time goes ("wkv6 parts": copies
with one part of its chunk loop compiled out, and mma.sync TF32 alone).
Every failed check raises, so the exit code is non-zero and no result
line is printed.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

preceded by one JSON line ``{"kernels": [...]}`` (launches summed over
the runs of each kernel's path, an allreduce, training or serving, each
run counted from 0 just before it and read just after it; times from
CUDA events in
this run, each the median of 5 rounds of about 20 ms of back-to-back
calls) and the card's name and power limit from nvidia-smi.

It needs a CUDA device and the repository around it; without either it
exits non-zero.
"""
from __future__ import annotations

import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
N_VERT = 16
N_PARAMS = 134_515_008         # smollm-135m, the stacked payload's width
M_ROW = N_PARAMS // 2          # one chunk row on the 4x4 torus (k=2)
# (rows, lanes) of the codec calls of pipelined S=1 and the per-tree and
# fused engines: a torus reduce hop packs and unpacks 16 vertex rows of a
# chunk row; the torus's pack-once broadcast packs and finally unpacks
# 16 x 2 (vertex, tree) rows; on the ring (k=1) every pack, combine and
# unpack is 16 full gradients, more than 2^31 elements.  path_shapes()
# adds the S=4 segments and the striped wires.
CODEC_SHAPES = ((N_VERT, M_ROW), (2 * N_VERT, M_ROW), (N_VERT, N_PARAMS))
FABRICS = {"torus4x4": (4, 4), "ring16": (16,)}
# ragged codec shapes, each at x storage offsets of 0-3 floats, with and
# without an all-zero row and a row of one large value: m = 1, 3, 4, 15,
# 16, 17 around one 16-byte vector, m = 1, 2, 3 mod 4 over 4-6 rows (x
# rows and wire rows of m + 4 bytes start at every 16-byte phase)
CODEC_SMALL = ((1, 5), (3, 257), (32, 4099), (5, 1), (5, 3), (5, 4), (5, 15),
               (5, 16), (5, 17), (5, 2049), (5, 2050), (6, 2051), (4, 2052))


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def timed(fn, rounds=5, fill_ms=20.0):
    """ms of one ``fn()`` call: the median over ``rounds`` rounds of the
    mean of back-to-back calls, each round as many calls as fill about
    ``fill_ms`` (at least one), by CUDA events around the round.  One
    warm-up call and one timed call that sizes the rounds come first, so a
    call of tens of microseconds is timed over hundreds of calls and not
    over its first slow few."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(iters):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fn()
    torch.cuda.synchronize()
    iters = max(1, math.ceil(fill_ms / max(run(1), 1e-3)))
    return sorted(run(iters) for _ in range(rounds))[rounds // 2]


def max_err(a, b):
    return float((a - b).abs_().max())


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time for the work: bytes over HBM rate or operations over
    the rate of their type, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def libraries():
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.tree_combine import kernel as K
    from repro_torch.kernels.wkv6 import kernel as WK
    return {"tree_combine": K, "flash_attention": FK, "rglru": RK,
            "wkv6": WK}


def phase_build():
    from repro_torch.kernels._build import build_all
    mods = libraries()
    t0 = time.perf_counter()
    build_all([m.LIB for m in mods.values()])
    for m in mods.values():
        m.LIB.load()
    log(f"build: {len(mods)} libraries in {time.perf_counter() - t0:.1f}s")
    for name, m in mods.items():
        info = m.LIB.info
        log(f"build {name}: {Path(info['path']).name} "
            f"(nvcc {info.get('seconds', 0.0):.1f}s)")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"ptxas {name}: {line.strip()}")


def timed_row(name, src, replaces, err, fn, plain, library, nbytes, ops,
              ops_per_s=F32_OPS_PER_S):
    """Time the kernel, its plain version and the library call; return the
    kernel's row of the result line (launches are filled in later)."""
    ms, pms = timed(fn), timed(plain)
    lms = timed(library) if library is not None else None
    b, by = bound_ms(nbytes, ops, ops_per_s)
    log(f"{name}: {ms:.3f} ms (bound {b:.3f} ms by {by}, plain "
        f"{pms:.3f} ms, library {lms if lms is None else round(lms, 3)}"
        f" ms), max_abs_err {err:g}")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
            "library_ms": lms}


def pack_input(dev, g, rows, m, offset, edges):
    """(rows, m) f32 as a contiguous view ``offset`` floats into its
    buffer; with ``edges`` the second-to-last row all zeros (scale 1e-30)
    and the last one large value among N(0, 1) lanes."""
    import torch
    buf = torch.randn((rows * m + offset,), generator=g, device=dev) * 3.3
    x = buf[offset:].view(rows, m)
    if edges and rows >= 2:
        x[-2] = 0.0
        x[-1, m // 2] = 1e6
    return x


def path_shapes():
    """What the allreduce engines hand the kernels at full width beyond
    CODEC_SHAPES: ``(codec shapes, combine windows)``.  Pipelined S=4
    packs, unpacks and combines one ``(16, ceil(mrow / 4))`` segment of a
    chunk row a hop; a striped wave packs and unpacks 16 rows of its wire
    width (the widest wave of each fabric) and adds each arrival into a
    circular window of a vertex's row, at most two slices (the widest
    reduce window of each fabric, as ``(row width, [(row offset, arrival
    offset, width), ...])``)."""
    from repro_torch.core.collectives import REDUCE, striped_tables
    codec = [(N_VERT, -(-M_ROW // 4)), (N_VERT, -(-N_PARAMS // 4))]
    windows = []
    for dims in FABRICS.values():
        bound = striped_tables(engine_specs(dims)["striped"], N_PARAMS)
        codec.append((N_VERT, max(bw.wire for bw in bound.waves)))
        length, off = max((int(bw.recv_len[d]), int(bw.recv_off[d]))
                          for bw in bound.waves if bw.op == REDUCE
                          for _, d in bw.perm)
        first = min(length, bound.mrow - off)
        slices = [(off, 0, first)] + ([(0, first, length - first)]
                                      if length > first else [])
        windows.append((bound.mrow, slices))
    return codec, windows


def phase_kernels(dev):
    """Each kernel against its plain version at the path's shapes and at
    ragged ones; returns the per-kernel rows of the result line."""
    import torch
    from repro_torch.kernels.tree_combine import kernel as K
    from repro_torch.kernels.tree_combine import ref as R
    g = torch.Generator(device=dev).manual_seed(0)

    # ragged shapes and every combine dtype first: cheap, and a fault
    # shows at a readable size
    for nch, length in ((5, 17), (3, 1000), (1, 4097)):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            recv = torch.randn((nch, length), generator=g, device=dev).to(dt)
            part = torch.randn((length,), generator=g, device=dev).to(dt)
            ref = R.tree_combine_ref(recv, part).float()
            err = float((K.tree_combine(recv, part).float() - ref)
                        .abs().max())
            # f32: sums of children may be taken in another order; bf16 /
            # f16: one rounding of the f32 sum, so one ulp of the largest
            scale = max(1.0, float(ref.abs().max()))
            tol = scale * (1e-6 if dt == torch.float32 else 2.0 ** -7)
            assert err <= tol, ("tree_combine", nch, length, dt, err)
    # misaligned and ragged: contiguous views one element off 16 bytes,
    # so the scalar head and tail take what the vector body cannot
    for nch, length in ((1, 4097), (2, 1001), (5, (1 << 20) + 3)):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            rbuf = torch.randn((nch * length + 1,), generator=g,
                               device=dev).to(dt)
            pbuf = torch.randn((length + 1,), generator=g, device=dev).to(dt)
            for ro, po in ((1, 1), (0, 1), (1, 0)):
                recv = rbuf[ro:ro + nch * length].view(nch, length)
                part = pbuf[po:po + length]
                ref = R.tree_combine_ref(recv, part).float()
                err = float((K.tree_combine(recv, part).float() - ref)
                            .abs().max())
                scale = max(1.0, float(ref.abs().max()))
                tol = scale * (1e-6 if dt == torch.float32 else 2.0 ** -7)
                assert err <= tol, ("tree_combine", nch, length, dt, ro, po,
                                    err)
    for (rows, m), offset, edges in itertools.product(
            CODEC_SMALL, range(4), (False, True)):
        x = pack_input(dev, g, rows, m, offset, edges)
        w = K.q8_pack_rows(x)
        assert torch.equal(w, R.q8_pack_rows_ref(x)), ("q8_pack", rows, m,
                                                        offset, edges)
        part = torch.randn((rows, m), generator=g, device=dev)
        err = float((K.q8_combine_rows(w, part)
                     - R.q8_combine_rows_ref(w, part)).abs().max())
        assert err <= 1e-6, ("q8_combine_rows", rows, m, err)
        err = float((K.q8_unpack_rows(w) - R.q8_unpack_rows_ref(w))
                    .abs().max())
        assert err <= 1e-6, ("q8_unpack_rows", rows, m, err)
        z = torch.zeros_like(w)
        assert bool((K.q8_unpack_rows(z) == 0).all()), "zero wire"
    torch.cuda.synchronize()
    log("kernels: ragged shapes match the plain versions")

    rows = []
    src = "src/repro_torch/kernels/tree_combine/csrc/tree_combine.cu"
    ref_file = "src/repro/kernels/tree_combine/kernel.py"

    def row(name, line, err, fn, plain, library, nbytes, ops):
        rows.append(timed_row(name, src, f"{ref_file}:{line}", err, fn,
                              plain, library, nbytes, ops))

    # the reduce-hop accumulate: recv (1, 16*m), partial (16*m,)
    length = N_VERT * M_ROW
    part = torch.randn((length,), generator=g, device=dev)
    recv = torch.randn((1, length), generator=g, device=dev)
    # one child in f32: one rounded add, bit for bit the plain version
    out = K.tree_combine(recv, part)
    same = torch.equal(out, R.tree_combine_ref(recv, part)) \
        and torch.equal(out, torch.add(part, recv[0]))
    err = max_err(out, R.tree_combine_ref(recv, part))
    del out
    assert same, ("tree_combine is not bit-identical to the plain version "
                  "at the path's shape", err)
    row("tree_combine", 36, err, lambda: K.tree_combine(recv, part),
        lambda: R.tree_combine_ref(recv, part),
        lambda: torch.add(part, recv[0]), 3 * length * 4, length)
    del part, recv
    torch.cuda.empty_cache()

    # the new engines' accumulates: an S=4 segment of every vertex, and a
    # striped arrival into its circular window's slices (views at the
    # window's own storage offsets), each bit for bit the plain version
    engine_shapes, windows = path_shapes()
    for rows_, m in engine_shapes[:2]:
        part = torch.randn((rows_ * m,), generator=g, device=dev)
        recv = torch.randn((1, rows_ * m), generator=g, device=dev)
        assert torch.equal(K.tree_combine(recv, part),
                           R.tree_combine_ref(recv, part)), \
            ("tree_combine at an S=4 segment", rows_, m)
        del part, recv
    for mrow, slices in windows:
        state = torch.randn((mrow,), generator=g, device=dev)
        arrival = torch.randn((sum(w for _, _, w in slices),), generator=g,
                              device=dev)
        for lo, at, width in slices:
            window = state[lo:lo + width]
            recv = arrival[at:at + width].view(1, -1)
            assert torch.equal(K.tree_combine(recv, window),
                               R.tree_combine_ref(recv, window)), \
                ("tree_combine at a striped window", mrow, lo, at, width)
        del state, arrival
    torch.cuda.empty_cache()
    log(f"kernels: tree_combine at the S=4 segments {engine_shapes[:2]} "
        f"and the striped windows {windows} matches the plain version bit "
        f"for bit")

    # the codec at every shape the path gives it, one shape at a time;
    # timed at the ring's, the largest and the only one of q8_combine_rows
    for shape in CODEC_SHAPES + tuple(engine_shapes):
        timed_here = shape == (N_VERT, N_PARAMS)
        x = torch.randn(shape, generator=g, device=dev) * 3.3
        w = K.q8_pack_rows(x)
        same = torch.equal(w, R.q8_pack_rows_ref(x))
        assert same, ("q8_pack_rows is not byte-identical to the plain "
                      "version", shape)
        nx, nw, nel = x.numel() * 4, w.numel(), x.numel()
        if timed_here:
            row("q8_pack_rows", 81, 0.0, lambda: K.q8_pack_rows(x),
                lambda: R.q8_pack_rows_ref(x), None, nx + nw, 3 * nel)
            ms = rows[-1]["ms"]
        else:
            ms = timed(lambda: K.q8_pack_rows(x))
        # any exact pack reads x twice: a row's scale needs its whole
        # absmax, and a row is far larger than the L2
        floor = (2 * nx + nw) / HBM_BYTES_PER_S * 1e3
        log(f"q8_pack_rows at {shape}: {ms!r} ms, bound "
            f"{bound_ms(nx + nw, 3 * nel)[0]!r} ms (bytes, x read once), "
            f"two-read floor {floor!r} ms ((2 * 4 + 1) * R * m bytes), "
            f"{floor / ms:.1%} of the floor")
        del x
        err = max_err(K.q8_unpack_rows(w), R.q8_unpack_rows_ref(w))
        assert err <= 1e-6, ("q8_unpack_rows", shape, err)
        if timed_here:
            row("q8_unpack_rows", 118, err, lambda: K.q8_unpack_rows(w),
                lambda: R.q8_unpack_rows_ref(w), None, nw + nx, nel)
            part = torch.randn(shape, generator=g, device=dev)
            err = max_err(K.q8_combine_rows(w, part),
                          R.q8_combine_rows_ref(w, part))
            assert err <= 1e-6, ("q8_combine_rows", shape, err)
            row("q8_combine_rows", 100, err,
                lambda: K.q8_combine_rows(w, part),
                lambda: R.q8_combine_rows_ref(w, part), None,
                nw + 2 * nx, 2 * nel)
            del part
        del w
        torch.cuda.empty_cache()
        log(f"kernels: codec at {shape} matches the plain versions")
    return rows


# (b, s, h, kv, d, causal, window): the reference's five kernel-test
# cases, then the two serving layouts at ragged lengths
FLASH_SMALL = ((2, 128, 8, 2, 64, True, None), (1, 100, 4, 4, 32, True, None),
               (2, 256, 8, 1, 128, True, 48), (1, 128, 2, 2, 64, False, None),
               (1, 64, 4, 2, 128, True, None), (2, 333, 10, 1, 256, True, 100),
               (3, 301, 9, 3, 64, True, None), (2, 40, 10, 1, 256, True, None),
               (2, 129, 10, 1, 256, True, 65), (2, 127, 9, 3, 64, True, 63),
               (1, 191, 10, 1, 128, True, 1), (1, 65, 4, 2, 32, True, 64))
# the prefill attention of each served model: (b, s, h, kv, d, window)
FLASH_PATH = {"recurrentgemma-2b": (8, 4096, 10, 1, 256, 2048),
              "smollm-135m": (8, 1024, 9, 3, 64, None)}
# (batch, prompt, generated tokens) served per model
SERVE = {"recurrentgemma-2b": (8, 4096, 32), "smollm-135m": (8, 1024, 32),
         "rwkv6-7b": (8, 4096, 32)}
RG_SCAN = (8, 4096, 2560)      # one RG-LRU layer's scan in that prefill
PATH_LAUNCHES = {"recurrentgemma-2b": {"flash_attention": 8,
                                       "rglru_scan": 18, "wkv6": 0},
                 "smollm-135m": {"flash_attention": 30, "rglru_scan": 0,
                                 "wkv6": 0},
                 "rwkv6-7b": {"flash_attention": 0, "rglru_scan": 0,
                              "wkv6": 32}}
# (b, t, h, n, chunk): the reference kernel test's three shapes, then
# ragged ones at N 64, 32 and 16 (a ragged last chunk, T < chunk)
WKV_SMALL = ((2, 100, 3, 16, 32), (1, 64, 2, 64, 64), (2, 33, 4, 8, 16),
             (3, 130, 5, 64, 64), (2, 20, 3, 32, 64), (2, 77, 4, 16, 64))
# logw = -exp(a x + c), x ~ N(0, 1): the model's decays (w0 = -6), the
# reference kernel test's, and a strong decay that passes the clamp
WKV_DECAYS = {"model": (0.3, -6.0), "reference test": (0.5, -4.0),
              "strong": (0.5, 2.0)}
WKV_PATH = (8, 4096, 64, 64)   # one rwkv6-7b prefill layer: B, T, H, N
WKV_CHUNK = 64
# parts of the WKV6 kernel's chunk loop that wkv6_parts compiles out, each
# cut from the source as [start marker, end marker); the copies of the
# next chunk are cut by turning their condition false
WKV_PARTS = {
    "prefix": ("    // 1. the decay prefix",
               "    __syncthreads();\n\n    // 2. o of strip"),
    "o": ("    // 2. o of strip", "    // 3. kdecay^T v"),
    "state": ("#pragma unroll\n    for (int kk = 0; kk < 8; ++kk) {"
              "          // rows past",
              "    __syncthreads();  // every read of S"),
}
WKV_LOADS = "    if (c + 1 < nc) {"
WKV_CUTS = {"no prefix": ("prefix",), "no o": ("o",),
            "no state": ("state",), "no loads": ("loads",),
            "loads only": ("prefix", "o", "state")}
# mma.sync m16n8k8 TF32 alone: 8 independent accumulators a warp
MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) mma_tf32_rate(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
          "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(void* out, int blocks, int iters) {
  mma_tf32_rate<<<blocks, 256>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def live_pairs(s, window):
    """(query, key) pairs per head that causality and the window keep."""
    return sum(min(t + 1, window) if window else t + 1 for t in range(s))


def phase_flash(dev):
    """Flash attention against its plain version at ragged shapes and at
    each serving path's prefill shape; returns its row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                          bf16_kernel_bound)
    g = torch.Generator(device=dev).manual_seed(2)

    def qkv(b, s, h, kv, d, dt):
        return (torch.randn((b, s, n, d), generator=g, device=dev).to(dt)
                for n in (h, kv, kv))

    # the reference's tolerances: f32 sums in another order; bf16 one
    # rounding of the f32 output
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def check(q, k, v, causal, window, *where):
        """max|kernel - plain| under the reference's tolerance, and in bf16
        every element under the tensor-core kernel's rounding bound (the
        many-key rows' outputs are far under 2e-2); returns the max and
        the largest share of that bound (0 in f32)."""
        ref = attention_ref(q, k, v, causal=causal, window=window)
        err = (FK.flash_attention(q, k, v, causal=causal, window=window)
               .float() - ref.float()).abs_()
        worst, share = float(err.max()), 0.0
        assert worst < tol[q.dtype], ("flash_attention", *where, q.dtype,
                                      worst)
        if q.dtype == torch.bfloat16:
            share = float(err.div_(bf16_kernel_bound(
                q, k, v, ref, causal=causal, window=window)).max())
            assert share <= 1.0, ("flash_attention bf16 over its "
                                  "per-element bound", *where, share)
        return worst, share

    for b, s, h, kv, d, causal, window in FLASH_SMALL:
        for dt in (torch.float32, torch.bfloat16):
            check(*qkv(b, s, h, kv, d, dt), causal, window, b, s, h, kv, d)
    torch.cuda.synchronize()
    log("flash_attention: ragged shapes match the plain version")

    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    replaces = "src/repro/kernels/flash_attention/kernel.py:85"
    timings = {}
    for arch, (b, s, h, kv, d, window) in FLASH_PATH.items():
        # bf16 on the tensor-core kernel at both shapes, and f32 on the
        # CUDA-core kernel at recurrentgemma-2b's
        for dt in ((torch.bfloat16, torch.float32)
                   if arch == "recurrentgemma-2b" else (torch.bfloat16,)):
            q, k, v = qkv(b, s, h, kv, d, dt)
            err, share = check(q, k, v, True, window, arch)
            torch.cuda.empty_cache()
            pos = torch.arange(s, device=dev)
            mask = pos[None, :] <= pos[:, None]
            if window:
                mask &= pos[None, :] > pos[:, None] - window
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
            ops = 4 * b * h * d * live_pairs(s, window)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            log(f"flash_attention at {arch}'s prefill {tuple(q.shape)} / "
                f"{tuple(k.shape)} {name}, window {window}: {ops:.4g} "
                f"operations; max|err| {err!r}"
                + (f", {share!r} of the per-element bound" if share else ""))
            row = timed_row(
                "flash_attention", src, replaces, err,
                lambda: FK.flash_attention(q, k, v, window=window),
                lambda: attention_ref(q, k, v, window=window),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True),
                nbytes, ops,
                BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
            if not window:
                # no window: the same function is SDPA's is_causal form
                row["library_ms_is_causal"] = timed(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True))
                log(f"flash_attention at {arch}'s prefill: SDPA is_causal "
                    f"{row['library_ms_is_causal']:.3f} ms")
            timings[f"{arch} prefill {name}"] = row
            del q, k, v, qt, kt, vt, mask
            torch.cuda.empty_cache()
    row = timings.pop("recurrentgemma-2b prefill bf16")
    row["shape"] = "recurrentgemma-2b prefill bf16"
    row["other_shapes"] = {tag: {k: r[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_ms_is_causal") if k in r}
        for tag, r in timings.items()}
    return row


def phase_rglru(dev):
    """The RG-LRU scan against its plain version at ragged shapes and at
    the recurrentgemma-2b prefill's; returns its row."""
    import torch
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_ref
    g = torch.Generator(device=dev).manual_seed(3)

    def gates(b, t, w):
        """The model's decays a = exp(-8 softplus(lam) r) and inputs."""
        lam = torch.linspace(0.9, 4.0, w, device=dev)
        r = torch.sigmoid(torch.randn((b, t, w), generator=g, device=dev))
        a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
        bx = torch.sqrt(1 - a * a) * torch.randn((b, t, w), generator=g,
                                                  device=dev)
        return a, bx

    # the kernel rounds the multiply and the add as the plain loop does,
    # so the two agree bit for bit
    for b, t, w in ((2, 100, 48), (3, 17, 8), (1, 257, 130)):
        a, bx = gates(b, t, w)
        for h0 in (None, torch.randn((b, w), generator=g, device=dev)):
            h, hl = RK.rglru_scan(a, bx, h0)
            rh, rl = rglru_ref(a, bx, h0)
            assert torch.equal(h, rh) and torch.equal(hl, rl), (b, t, w)
    torch.cuda.synchronize()
    log("rglru_scan: ragged shapes match the plain version bit for bit")

    a, bx = gates(*RG_SCAN)
    h, hl = RK.rglru_scan(a, bx)
    rh, rl = rglru_ref(a, bx)
    err = max(max_err(h, rh), max_err(hl, rl))
    assert err == 0.0, ("rglru_scan", err)
    del h, hl, rh, rl
    n = a.numel()
    row = timed_row("rglru_scan",
                    "src/repro_torch/kernels/rglru/csrc/rglru.cu",
                    "src/repro/kernels/rglru/kernel.py:45", err,
                    lambda: RK.rglru_scan(a, bx), lambda: rglru_ref(a, bx),
                    None, 3 * n * 4 + RG_SCAN[0] * RG_SCAN[2] * 4, 2 * n)
    row["shape"] = "recurrentgemma-2b prefill"
    del a, bx
    torch.cuda.empty_cache()
    return row


def wkv_within(out, ref, dtype):
    """f32: sums in another order, 2e-4 of the largest output (the
    reference kernel test's 2e-4, scaled to the output's size); bf16 one
    bf16 rounding of each output on top.  Returns (ok, max |diff|)."""
    import torch
    atol = 2e-4 * max(1.0, float(ref.float().abs().max()))
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, float(diff.max())


def phase_wkv6(dev):
    """WKV6 against its plain version at ragged shapes (f32 and bf16, with
    and without an initial state, three decay regimes) and at one rwkv6-7b
    prefill layer's shape; returns its row."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as WK
    from repro_torch.kernels.wkv6.ref import CLAMP, wkv6_ref
    g = torch.Generator(device=dev).manual_seed(4)
    # ptxas of both instantiations (f32, bf16): registers, static shared
    # memory (the tiles are dynamic: 214,560 and 165,120 bytes), spills
    ptxas = [ln.strip() for ln in WK.LIB.info.get("log", "").splitlines()
             if "Used" in ln or "spill" in ln]
    log(f"wkv6 ptxas: {' | '.join(ptxas) if ptxas else 'no build log'}")

    def inputs(b, t, h, n, dt, decay):
        r, k, v = (torch.randn((b, t, h, n), generator=g, device=dev).to(dt)
                   for _ in range(3))
        a, c = decay
        logw = -torch.exp(a * torch.randn((b, t, h, n), generator=g,
                                          device=dev) + c)
        u = 0.5 * torch.randn((h, n), generator=g, device=dev)
        s0 = torch.randn((b, h, n, n), generator=g, device=dev)
        return r, k, v, logw, u, s0

    worst = 0.0
    for b, t, h, n, chunk in WKV_SMALL:
        for dt in (torch.float32, torch.bfloat16):
            for regime, decay in WKV_DECAYS.items():
                r, k, v, logw, u, s0 = inputs(b, t, h, n, dt, decay)
                c = min(chunk, t)
                reach = float(-logw[:, :c].cumsum(1).min())
                assert (reach > CLAMP) == (regime == "strong"), (regime,
                                                                  reach)
                for init in (None, s0):
                    out, s = WK.wkv6(r, k, v, logw, u, init, chunk=chunk)
                    ro, rs = wkv6_ref(r, k, v, logw, u, init, chunk=chunk)
                    ok_o, e_o = wkv_within(out, ro, dt)
                    ok_s, e_s = wkv_within(s, rs, torch.float32)
                    finite = bool(torch.isfinite(out.float()).all()
                                  and torch.isfinite(s).all())
                    assert ok_o and ok_s and finite, (
                        "wkv6", b, t, h, n, chunk, dt, regime,
                        init is not None, e_o, e_s)
                    worst = max(worst, e_o / max(1.0, float(
                        ro.float().abs().max())))
    torch.cuda.synchronize()
    log(f"wkv6: ragged shapes match the plain version (largest error "
        f"{worst:.3g} of the largest output)")

    b, t, h, n = WKV_PATH
    r, k, v, logw, u, _ = inputs(b, t, h, n, torch.bfloat16,
                                 WKV_DECAYS["model"])
    out, s = WK.wkv6(r, k, v, logw, u, chunk=WKV_CHUNK)
    ro, rs = wkv6_ref(r, k, v, logw, u, chunk=WKV_CHUNK)
    ok_o, e_o = wkv_within(out, ro, torch.bfloat16)
    ok_s, e_s = wkv_within(s, rs, torch.float32)
    log(f"wkv6 at rwkv6-7b's prefill {WKV_PATH} bf16: max|out| "
        f"{float(ro.float().abs().max())!r}, max|state| "
        f"{float(rs.abs().max())!r}, max|d out| {e_o!r}, max|d state| "
        f"{e_s!r}")
    assert ok_o and ok_s, ("wkv6", e_o, e_s)
    del out, s, ro, rs
    c, nc = WKV_CHUNK, -(-t // WKV_CHUNK)
    # r, k, v read and out written in bf16, logw read in f32, the f32
    # state written
    nbytes = 4 * r.numel() * r.element_size() + logw.numel() * 4 \
        + b * h * n * n * 4
    ops = b * h * nc * 2 * (c * (c - 1) * n + 2 * c * n * n)
    row = timed_row("wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                    "src/repro/kernels/wkv6/kernel.py:75", e_o,
                    lambda: WK.wkv6(r, k, v, logw, u, chunk=WKV_CHUNK),
                    lambda: wkv6_ref(r, k, v, logw, u, chunk=WKV_CHUNK),
                    None, nbytes, ops, TF32_OPS_PER_S)
    row["shape"] = "rwkv6-7b prefill"
    wkv6_parts(dev, row["ms"], r, k, v, logw, u)
    del r, k, v, logw, u
    torch.cuda.empty_cache()
    return row


def cut_wkv6(source, parts):
    """The kernel's source with ``parts`` (keys of WKV_PARTS, or "loads")
    compiled out; raises if a marker moved."""
    for part in parts:
        if part == "loads":
            if source.count(WKV_LOADS) != 1:
                raise RuntimeError("wkv6 parts: the loads moved")
            source = source.replace(WKV_LOADS, "    if (false) {")
            continue
        start, end = WKV_PARTS[part]
        i, j = source.find(start), source.find(end)
        if source.count(start) != 1 or j < i:
            raise RuntimeError(f"wkv6 parts: the {part} part moved")
        source = source[:i] + source[j:]
    return source


def wkv6_parts(dev, full_ms, r, k, v, logw, u):
    """Where WKV6's time goes at the path's shape: copies of the kernel
    with one part of its chunk loop compiled out (WKV_CUTS), each a wrong
    function that is timed and never checked, against the full kernel's
    ``full_ms``; and mma.sync TF32 alone, the most its products could
    reach.  Logs each; launches nothing through the wrappers."""
    import ctypes

    import torch
    from repro_torch.kernels._build import Library, build_all, build_dir
    from repro_torch.kernels.wkv6 import kernel as WK
    out_dir = build_dir()
    libs = {}
    for name, parts in WKV_CUTS.items():
        path = out_dir / f"wkv6_part{len(libs)}.cu"
        path.write_text(cut_wkv6(WK.LIB.source.read_text(), parts))
        libs[name] = Library(path, f"wkv6_part{len(libs)}",
                             WK.LIB.signatures)
    mma_path = out_dir / "mma_tf32_rate.cu"
    mma_path.write_text(MMA_RATE_SOURCE)
    mma = Library(mma_path, "mma_tf32_rate",
                  {"mma_rate": [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]})
    build_all(list(libs.values()) + [mma])

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty((4 * sms * 256,), device=dev)
    iters = 4000
    assert mma.load().mma_rate(sink.data_ptr(), 4 * sms, iters) == 0
    ms = timed(lambda: mma.load().mma_rate(sink.data_ptr(), 4 * sms, iters))
    flops = 2 * 16 * 8 * 8 * (4 * sms * 8 * iters * 8)
    log(f"wkv6 parts: mma.sync m16n8k8 TF32 alone {flops / ms / 1e9!r} "
        f"TFLOP/s")
    b, t, h, n = r.shape
    out = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, lib in libs.items():
        fn = lib.load().wkv6

        def call(fn=fn):
            err = fn(1, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                     logw.data_ptr(), u.data_ptr(), None, out.data_ptr(),
                     s_fin.data_ptr(), b, t, h, n, WKV_CHUNK, stream)
            assert err == 0, (name, err)

        ms = timed(call)
        log(f"wkv6 parts: {name} {ms!r} ms ({ms - full_ms!r} ms against "
            f"the full kernel's {full_ms!r})")


def reset_all():
    for m in libraries().values():
        m.reset_launches()


def counts():
    out = {}
    for m in libraries().values():
        out.update(m.LAUNCHES)
    return out


def f32_decode_check(dev, arch, prompt):
    """At full width in f32: prefill ``prompt`` tokens, decode one, and
    hold the decode's logits (plain attention over the cache, one plain
    recurrence step) against the last logits of a prefill of the same
    ``prompt + 1`` tokens (the kernels).  The two sum in different orders
    (kernel tiles against a one-block softmax, a sequential scan or the
    chunked WKV against one step, other matmul shapes).  On an H100 that
    reorder gave 1.4e-5 (recurrentgemma-2b), 2.5e-6 (smollm-135m) and
    2.4e-5 (rwkv6-7b) of the largest logit, so the limit is 1e-4 of it:
    7, 40 and 4 times those readings."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import model_fns
    cfg = dataclasses.replace(configs.get(arch), act_dtype_name="float32")
    init, prefill, decode = model_fns(cfg)
    b = SERVE[arch][0]
    with torch.inference_mode():
        params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (b, prompt), generator=gen,
                                device=dev)
        logits, caches = prefill(params, prompts, prompt + 1)
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        dec, _ = decode(params, caches, tok, prompt)
        del caches
        full, _ = prefill(params, torch.cat([prompts, tok], 1), prompt + 1)
        dec, full = dec[:, :cfg.vocab], full[:, :cfg.vocab]
        err = max_err(dec, full)
        scale = float(full.abs().max())
        same = bool((dec.argmax(-1) == full.argmax(-1)).all())
    tol = 1e-4 * max(1.0, scale)
    log(f"f32 check {arch}: decode at {prompt} vs prefill of {prompt + 1}: "
        f"max|dlogit| {err!r} <= {tol!r} (1e-4 * max(1, max|logit| "
        f"{scale!r})), greedy tokens equal {same}")
    assert math.isfinite(err) and err <= tol, (arch, err, tol)
    del params
    torch.cuda.empty_cache()


def phase_serve(dev):
    """Full-width serving through the entry point, one run per model, each
    counted from 0 just before it and read just after; then the f32 check
    of each.  Each counted run follows an uncounted one at the same shape
    (one token), so its prefill is timed warm: the memory pool already
    grown and each matmul shape's first cuBLAS call behind it.  Returns
    ``{run: {kernel: launches}}``."""
    import torch
    from repro_torch.launch import serve
    per_run = {}
    for arch, (batch, prompt, gen) in SERVE.items():
        argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
                str(prompt), "--device", "cuda"]
        torch.cuda.empty_cache()
        cold = serve.main(argv + ["--gen", "1"]).prefill_seconds
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all()
        t0 = time.perf_counter()
        res = serve.main(argv + ["--gen", str(gen)])
        torch.cuda.synchronize()
        tag = f"serve {arch}"
        per_run[tag] = c = counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"{tag}: batch {batch} x prompt {prompt}, {gen} tokens, bf16: "
            f"prefill {res.prefill_seconds!r}s warm, {cold!r}s cold "
            f"({batch * prompt / res.prefill_seconds!r} tok/s warm), decode "
            f"{res.decode_tokens_per_s!r} tok/s, peak memory "
            f"{peak / 1e9:.2f} GB, {time.perf_counter() - t0:.1f}s in all, "
            f"launches {c}")
        log(f"{tag}: first row {res.tokens[0].tolist()}")
        assert tuple(res.tokens.shape) == (batch, gen), res.tokens.shape
        assert bool(torch.isfinite(res.last_logits.float()).all()), tag
        for name, n in PATH_LAUNCHES[arch].items():
            assert c[name] == n, (tag, name, c[name], n)
        del res
        f32_decode_check(dev, arch, prompt)
    return per_run


# the engines phase_allreduce runs, and the (fabric, mesh dims, codec) cells
ENGINES = ("per_tree", "fused", "pipelined", "pipelined_s4", "striped")
TWIN_SLICE = 1_000_003        # payload lanes each engine also sums on the CPU
ALLREDUCE_CELLS = (("torus4x4", (4, 4), "off"), ("torus4x4", (4, 4), "full"),
                   ("ring16", (16,), "full"))


def engine_specs(dims):
    """Every engine's compiled program for the DP fabric of ``dims``."""
    from repro_torch.core import topologies as topo
    from repro_torch.core.collectives import (allreduce_schedule,
                                              fused_spec_from_schedule,
                                              pipelined_spec_from_schedule,
                                              striped_spec_from_schedule)
    from repro_torch.core.edst_star import star_edsts
    from repro_torch.dist.tree_allreduce import spec_from_schedule
    sp = topo.device_topology(dims)
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    axes = ("a", "b")
    pipe = pipelined_spec_from_schedule(sched, axes)
    return {"per_tree": spec_from_schedule(sched, axes),
            "fused": fused_spec_from_schedule(sched, axes),
            "pipelined": pipe, "pipelined_s4": pipe,
            "striped": striped_spec_from_schedule(sched, axes)}


def run_engine(engine, x, spec, fabric, codec):
    """One allreduce of the stacked payload through the engine's entry
    point (the per-tree engine takes the device's codec: int8 on CUDA)."""
    from repro_torch.dist import striped, tree_allreduce as T
    q = codec != "off"
    if engine == "per_tree":
        return T.per_tree_allreduce(x, spec, fabric, quantize=q)
    if engine == "fused":
        return T.fused_tree_allreduce(x, spec, fabric, quantize=q,
                                      codec=codec)
    if engine == "striped":
        return striped.striped_allreduce(x, spec, fabric, quantize=q,
                                         codec=codec)
    return T.pipelined_tree_allreduce(
        x, spec, fabric, quantize=q, codec=codec,
        segments=4 if engine == "pipelined_s4" else 1)


def ulps_off(y, ref):
    """Elements of ``y`` more than 4 ulps of ``ref``'s value off it, and
    the largest difference."""
    import torch
    a = ref.abs()
    tol = 4 * (torch.nextafter(a, torch.full_like(a, math.inf)) - a)
    diff = (y - ref).abs()
    return int((diff > tol).sum()), float(diff.max())


def cpu_twin(engine, xs, spec, codec):
    """The engine's sum of the stacked ``xs`` on the CPU, through the plain
    versions of the kernels, at ``codec``.  The per-tree engine's own
    codec on the CPU is "off", so there its trees run through
    ``run_tree_program`` at ``codec``, chunked as the engine chunks."""
    import torch
    import torch.nn.functional as F
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.tree_allreduce import run_tree_program
    fabric = StackedFabric(N_VERT, xs.device)
    if engine != "per_tree" or codec == "off":
        return run_engine(engine, xs, spec, fabric, codec)
    size = xs.shape[1]
    chunks = F.pad(xs, (0, -size % spec.k)).view(N_VERT, spec.k, -1)
    return torch.cat([run_tree_program(chunks[:, j].contiguous(), tree,
                                       fabric, True, codec=codec)
                      for j, tree in enumerate(spec.trees)], 1)[:, :size]


def program_waves(engine, spec, codec):
    """Waves of the program the engine runs (hops at 4 segments: every
    wave moves each of the 4 segments once)."""
    from repro_torch.core.collectives import striped_tables, wave_wire_bytes
    if engine == "striped":
        return len(striped_tables(spec, N_PARAMS).waves)
    if engine.startswith("pipelined"):
        waves = len(spec.q8_waves if codec != "off" else spec.waves)
        return waves * (4 if engine == "pipelined_s4" else 1)
    return len(wave_wire_bytes(spec, N_PARAMS * 4))


def phase_allreduce(dev):
    """Sum a random (16, 134,515,008) f32 payload with every engine on the
    4x4 torus (f32 and int8) and the ring 16 (int8) and hold each sum
    against ``payload.sum(0)``; pipelined S=4 in f32 must equal S=1 bit
    for bit.  Each engine also sums a ``(16, TWIN_SLICE)`` slice on the
    card and on the CPU (f32 bit for bit, int8 within 4 ulps of the
    value).  Each engine runs twice, the second run counted from 0 just
    before it and read just after it; returns ``{run: {kernel:
    launches}}``."""
    import torch
    from repro_torch.dist.fabric import StackedFabric
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((N_VERT, N_PARAMS), generator=g, device=dev)
    expect = x.sum(0)
    emax = float(expect.abs().max())
    # every int8 quantization errs by at most half a step, scale/2, and a
    # scale is at most max_i sum_v |x_v[i]| / 127 (partial sums never
    # exceed it); a total passes n-1 reduce packs and 1 broadcast pack
    sabs = float(x.abs().sum(0).max())
    xs = x[:, :TWIN_SLICE].contiguous()
    fabric = StackedFabric(N_VERT, dev)
    per_run = {}
    for name, dims, codec in ALLREDUCE_CELLS:
        specs = engine_specs(dims)
        one = None
        for engine in ENGINES:
            spec = specs[engine]
            secs, y = [], None
            for i in range(2):  # the first call also grows the memory pool
                y = None
                torch.cuda.synchronize()
                if i:
                    reset_all()
                t0 = time.perf_counter()
                y = run_engine(engine, x, spec, fabric, codec)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            tag = f"allreduce {engine} {name} {codec}"
            per_run[tag] = c = counts()
            # the same engine at a slice of the payload, on the card and on
            # the CPU: the kernels round as their plain versions do, so f32
            # is bit for bit and int8 within 4 ulps of the value
            ys = run_engine(engine, xs, spec, fabric, codec).cpu()
            yc = cpu_twin(engine, xs.cpu(), spec, codec)
            twin_bad, twin_diff = ulps_off(ys, yc)
            twin_equal = torch.equal(ys, yc)
            del ys, yc
            errs = [float((y[v] - expect).abs().max()) for v in range(N_VERT)]
            err = max(errs)
            same = bool((y == y[0]).all())
            if codec == "off":
                tol, rule = 1e-4 * emax, "1e-4 * max|sum|"
            else:
                tol = N_VERT * sabs / 254.0
                rule = "n * max_i sum_v|x_v[i]| / 254 (half step x hops)"
            equal_s1 = None
            if engine == "pipelined" and codec == "off":
                one = y
            elif engine == "pipelined_s4" and codec == "off":
                equal_s1 = torch.equal(y, one)
                one = None
            del y
            log(f"{tag}: k={spec.k} waves={program_waves(engine, spec, codec)}"
                f" {secs[0]!r}s then {secs[1]!r}s, max|err| {err:.3g} <= "
                f"{tol:.3g} [{rule}], rows identical {same}"
                + ("" if equal_s1 is None else f", equal to S=1 {equal_s1}")
                + f", launches {c}; at {tuple(xs.shape)} against the CPU: "
                f"equal {twin_equal}, max|diff| {twin_diff!r}, "
                f"{twin_bad} elements past 4 ulps")
            assert err <= tol, (tag, err, tol)
            assert twin_equal or (codec != "off" and not twin_bad), \
                (tag, "card and CPU differ", twin_diff, twin_bad)
            # the striped int8 allgather re-codes every hop (as the
            # reference's does), so its vertices hold different roundings
            assert same or (engine == "striped" and codec != "off"), tag
            assert equal_s1 is not False, (tag, "S=4 differs from S=1")
            if engine != "pipelined":       # the engines this slice added
                assert c["tree_combine"] > 0, (tag, c)
                if codec != "off":
                    assert c["q8_pack_rows"] > 0 and \
                        c["q8_unpack_rows"] > 0, (tag, c)
            torch.cuda.empty_cache()
    del x, xs, expect
    torch.cuda.empty_cache()
    return per_run


def trace_split(path, waves):
    """The profiled step's split from its Chrome trace: the second step's
    ``train/step1`` range (host clock, ends with the loss read), the
    ``edst/`` wave ranges inside it (asserted one a wave of the program),
    and the device's busy time (kernels, copies and fills, by the host
    range their launch falls in: the whole step, the sync's waves).
    Returns a dict of ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    step = next(e for e in ranges if e["name"] == "train/step1")
    lo, hi = step["ts"], step["ts"] + step["dur"]
    edst = [e for e in ranges if e["name"].startswith("edst/")
            and lo <= e["ts"] <= hi]
    assert len(edst) == waves, ("edst ranges in the profiled step",
                                len(edst), waves)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [(launched.get(e.get("args", {}).get("correlation")), e["dur"])
              for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device = [(t, d) for t, d in device if t is not None and lo <= t <= hi]
    in_waves = sum(d for t, d in device
                   if any(r["ts"] <= t <= r["ts"] + r["dur"] for r in edst))
    return {"step_ms": step["dur"] / 1e3,
            "waves_host_ms": sum(r["dur"] for r in edst) / 1e3,
            "device_busy_ms": sum(d for _, d in device) / 1e3,
            "device_busy_in_waves_ms": in_waves / 1e3,
            "device_events": len(device)}


def phase_train(dev):
    """Full-width smollm-135m through the training entry point, one run
    per path.  Every launch counter is set to 0 just before each run and
    read just after it; returns ``{run: {kernel: launches}}``."""
    import torch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    base = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
            "--log-every", "1", "--device", "cuda"]
    per_run = {}
    torch.cuda.reset_peak_memory_stats()

    def run(tag, extra, keep=False):
        reset_all()
        t0 = time.perf_counter()
        res = train.main(base + extra, keep_first_step=keep)
        torch.cuda.synchronize()
        per_run[tag] = counts()
        dt = time.perf_counter() - t0
        assert all(math.isfinite(v) for v in res.losses), (tag, res.losses)
        log(f"train {tag}: losses {res.losses}, grad norms "
            f"{res.grad_norms}, s/step {res.step_seconds}, {dt!r}s in all, "
            f"launches {per_run[tag]}")
        return res

    def flat(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    # the first step of each engine on the torus, to hold against psum_dp's
    # (and a warm second step, for its s/step)
    firsts = {}
    for engine in ("pipelined", "fused", "striped"):
        tag = "edst torus4x4" if engine == "pipelined" \
            else f"edst {engine} torus4x4"
        res = run(tag, ["--mesh", "4,4,1", "--sync", "edst", "--edst-engine",
                        engine, "--steps", "3" if engine == "pipelined"
                        else "2"], keep=True)
        p0 = flat(res.init_params)
        firsts[engine] = (flat(res.first_step_params) - p0, res.grad_norms[0])
        if engine == "pipelined":
            warm_step = min(res.step_seconds[1:])
        del res
    run("edst+q8 torus4x4", ["--mesh", "4,4,1", "--sync", "edst",
                             "--quantize-grads", "--steps", "3"])
    run("edst+q8 ring16", ["--mesh", "16,1", "--sync", "edst",
                           "--quantize-grads", "--steps", "1"])
    psum = run("psum_dp torus4x4", ["--mesh", "4,4,1", "--sync", "psum_dp",
                                    "--steps", "1"], keep=True)
    # the same first step: identical init (seed), batch and schedule.  The
    # step's move, not the params, is compared: Adam moves each parameter
    # by about lr * sign(g) whatever g's scale, so the grad norm (of the
    # mean gradient, before the clip) holds the sync's scale, and the move
    # relative to its own size shows a single flipped sign (~2e-4)
    assert torch.equal(flat(psum.init_params), p0), "different init"
    d_psum = flat(psum.params) - p0
    for engine, (d_edst, gn_edst) in firsts.items():
        rel = float((d_edst - d_psum).norm() / d_psum.norm())
        gn_rel = abs(gn_edst - psum.grad_norms[0]) / psum.grad_norms[0]
        log(f"edst {engine} vs psum_dp, step 1: |d_edst - d_psum| / "
            f"|d_psum| {rel!r} (<= 1e-5), max "
            f"{float((d_edst - d_psum).abs().max())!r}; grad norm "
            f"{gn_edst!r} vs {psum.grad_norms[0]!r}, relative {gn_rel!r} "
            f"(<= 1e-6)")
        assert rel <= 1e-5, (engine, rel)
        assert gn_rel <= 1e-6, (engine, gn_rel)
    del psum, firsts, d_psum

    # one profiled edst step (the second of two; the first warms up): one
    # edst/ range a wave of its program, and the device's busy time in them
    prof_dir = ROOT / "build" / "profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    res = run("edst torus4x4 profiled", ["--mesh", "4,4,1", "--sync", "edst",
                                         "--steps", "2", "--profile-dir",
                                         str(prof_dir)])
    from repro_torch.dist.steps import edst_spec_for_mesh
    waves = len(edst_spec_for_mesh((4, 4, 1), ("pod", "data",
                                               "model")).waves)
    split = trace_split(res.profile_trace, waves)
    # the profiler's own host cost stretches the profiled step, so the
    # device's share is also read against the unprofiled warm step
    log(f"profiled edst step (torus4x4, f32, step 2 of 2): {split}; "
        f"{waves} edst/ ranges; device busy "
        f"{split['device_busy_ms'] / split['step_ms']:.1%} of the profiled "
        f"step, {split['device_busy_ms'] / 1e3 / warm_step:.1%} of the "
        f"unprofiled warm step ({warm_step!r} s); in the waves "
        f"{split['device_busy_in_waves_ms']!r} ms "
        f"({split['device_busy_in_waves_ms'] / 1e3 / warm_step:.1%} of the "
        f"unprofiled step); host s/step {res.step_seconds}")
    # the split in PERF.md rests on the trace's device events: a trace
    # without them (no CUDA activity recorded) fails the run
    assert split["device_events"] > 0, ("no device events in the trace",
                                        split)
    assert split["device_busy_in_waves_ms"] > 0, ("no device time inside "
                                                  "the edst/ ranges", split)
    del res
    shutil.rmtree(prof_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"train peak memory: {peak / 1e9:.2f} GB")
    assert peak < 60e9, peak
    return per_run


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        sys.exit(f"chip_smoke: no repro_torch package under {SRC}")
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev) + [phase_flash(dev), phase_rglru(dev),
                                 phase_wkv6(dev)]

    # the main paths, each run counted on its own
    per_run = phase_allreduce(dev)
    per_run.update(phase_train(dev))
    per_run.update(phase_serve(dev))
    launches = {name: sum(c[name] for c in per_run.values())
                for name in counts()}
    log(f"launches over the allreduce, training and serving runs: "
        f"{launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on its path"
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["launches_by_path"] = {tag: c[r["name"]]
                                 for tag, c in per_run.items()}
    log(f"total {time.perf_counter() - t0:.1f}s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
