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
step's logits equal those of a prefill of the same tokens; then trains
ZeRO-1 over the torus (held to psum_dp, over the int8 wire, through the
striped fault runtime with a link of tree 0 killed and the moments
resharded, checkpointed and resumed bit for bit, restored onto a
degraded element map) and runs the recovery loop (--recover, a masked
probe fed to the controller until it flips, a step on the flipped
entry held to psum_dp); then closes the fault loop (every spec of these
paths proven by the static verifier; a seeded chaos trace of flap, kill,
burst, straggler, corruption and node loss driving training on the
torus, each recovery's first step held to psum_dp, the node loss
checkpointed and rescaled onto the 2x4 torus through the elastic entry
point, and training resumed there, f32 and int8; the Roskind-Tarjan
rescale onto all 15 survivors summing a (15, 134,515,008) payload; the
failure drill).  Beside
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

import contextlib
import io
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
TORUS_MESH, MESH_NAMES = (4, 4, 1), ("pod", "data", "model")
# after a node loss: the power-of-two sub-torus training resumes on
# (batch 32 does not split over 15 survivors), and the seeded vertex the
# Roskind-Tarjan rescale onto all 15 survivors drops
RESUME_MESH, RESUME_N = (2, 4, 1), 8
LOST_SEED = 0
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


def _widest_reduce_window(bound):
    """The widest reduce-scatter arrival of a bound striped program, as
    ``(row width, [(row offset, arrival offset, width), ...])``."""
    from repro_torch.core.collectives import REDUCE
    length, off = max((int(bw.recv_len[d]), int(bw.recv_off[d]))
                      for bw in bound.waves if bw.op == REDUCE
                      for _, d in bw.perm)
    first = min(length, bound.mrow - off)
    slices = [(off, 0, first)] + ([(0, first, length - first)]
                                  if length > first else [])
    return bound.mrow, slices


def path_shapes():
    """What the allreduce engines hand the kernels at full width beyond
    CODEC_SHAPES: ``(codec shapes, combine windows, hop rows)``. Pipelined
    S=4 packs, unpacks and combines one ``(16, ceil(mrow / 4))`` segment of
    a chunk row a hop; a striped wave packs and unpacks 16 rows of its wire
    width (the widest wave of each fabric) and adds each arrival into a
    circular window of a vertex's row, at most two slices (the widest
    reduce window of each fabric, as ``(row width, [(row offset, arrival
    offset, width), ...])``). The zero1 path's reduce-scatter adds, for
    each degraded and rebuilt entry of the torus's striped fault runtime
    (weighted by its fractions), its widest reduce-scatter wire and window.
    The elastic paths add their pipelined reduce hops, ``(n, mrow)`` rows
    (tree_combine over all n rows at once, the int8 wire's pack and unpack
    or combine, the broadcast's pack of n * k rows): the 15-vertex runtime
    a node loss rescales the torus onto (k = 2, rows as wide as its widest
    weighted chunk) and the 2x4 torus training resumes on (k = 1, whole
    gradients, every reduce hop ``sole_add``)."""
    from repro_torch.core.collectives import chunk_sizes, striped_tables
    from repro_torch.dist.steps import fault_runtime_for_mesh
    codec = [(N_VERT, -(-M_ROW // 4)), (N_VERT, -(-N_PARAMS // 4))]
    windows = []
    for dims in FABRICS.values():
        bound = striped_tables(engine_specs(dims)["striped"], N_PARAMS)
        codec.append((N_VERT, max(bw.wire for bw in bound.waves)))
        windows.append(_widest_reduce_window(bound))
    rt = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES, engine="striped")
    for e in rt.entries[1:]:
        bound = striped_tables(e.spec, N_PARAMS, e.fractions)
        shape = (N_VERT, max(bw.wire for bw in bound.rs_waves))
        if shape not in codec:
            codec.append(shape)
        window = _widest_reduce_window(bound)
        if window not in windows:
            windows.append(window)
    hops = []
    for e in (rescaled_runtime().entries[0],
              fault_runtime_for_mesh(RESUME_MESH, MESH_NAMES).entries[0]):
        hop = (e.spec.n, max(chunk_sizes(N_PARAMS, e.fractions)))
        hops.append(hop)
        for shape in (hop, (hop[0] * e.k, hop[1])):
            if shape not in codec and shape not in CODEC_SHAPES:
                codec.append(shape)
    return codec, windows, hops


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
    engine_shapes, windows, hops = path_shapes()
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
    for rows_, m in hops:
        part = torch.randn((rows_ * m,), generator=g, device=dev)
        recv = torch.randn((1, rows_ * m), generator=g, device=dev)
        assert torch.equal(K.tree_combine(recv, part),
                           R.tree_combine_ref(recv, part)), \
            ("tree_combine at an elastic reduce hop", rows_, m)
        del part, recv
    torch.cuda.empty_cache()
    log(f"kernels: tree_combine at the S=4 segments {engine_shapes[:2]}, "
        f"the striped windows {windows} and the elastic reduce hops "
        f"{hops} matches the plain version bit for bit")

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
        if shape == (RESUME_N, N_PARAMS):     # the 2x4 torus's sole_add
            part = torch.randn(shape, generator=g, device=dev)
            cerr = max_err(K.q8_combine_rows(w, part),
                           R.q8_combine_rows_ref(w, part))
            assert cerr <= 1e-6, ("q8_combine_rows", shape, cerr)
            del part
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

    # the first step of each engine on the torus, to hold against psum_dp's
    # (and a warm second step, for its s/step)
    firsts = {}
    for engine in ("pipelined", "fused", "striped"):
        tag = "edst torus4x4" if engine == "pipelined" \
            else f"edst {engine} torus4x4"
        res = run(tag, ["--mesh", "4,4,1", "--sync", "edst", "--edst-engine",
                        engine, "--steps", "3" if engine == "pipelined"
                        else "2"], keep=True)
        p0 = flat_of(res.init_params)
        firsts[engine] = (flat_of(res.first_step_params) - p0,
                          res.grad_norms[0])
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
    assert torch.equal(flat_of(psum.init_params), p0), "different init"
    d_psum = flat_of(psum.params) - p0
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


def _dense_state(step, mu, nu, emap, params):
    """The dense ``OptState`` holding the sharded moments ``mu`` / ``nu``
    laid out on the element map ``emap`` (numpy, -1 = padding)."""
    import torch
    from repro_torch.dist.steps import _unflatten
    from repro_torch.optim.adamw import OptState
    emap = torch.from_numpy(emap).to(mu.device)
    live = emap >= 0
    idx = emap[live]
    del emap
    out = []
    for m in (mu, nu):
        flat = torch.zeros((N_PARAMS,), dtype=torch.float32, device=m.device)
        flat[idx] = m[live]
        out.append(_unflatten(flat, params))
    return OptState(step, out[0], out[1])


def _held_to_psum(tag, params, dense_state, batch, new_params, grad_norm,
                  opt, mesh=TORUS_MESH):
    """Hold one step (``params`` -> ``new_params``, its pre-clip grad norm
    ``grad_norm``) to a psum_dp step on ``mesh`` from the same params and
    optimizer state: the move within 1e-5 of psum_dp's relative to its
    size, the grad norm within 1e-5 (both are sums over the vertices in
    another order).  Returns (move, grad norm) relative differences."""
    import torch
    from repro_torch import configs
    from repro_torch.dist.steps import make_train_step
    cfg = configs.get("smollm-135m")
    step = make_train_step(cfg, opt, mesh, MESH_NAMES, mode="psum_dp")
    ref, _, met = step(params, dense_state, batch)
    p0 = flat_of(params)
    d_ref, d_got = flat_of(ref) - p0, flat_of(new_params) - p0
    del ref, p0
    rel = float((d_got - d_ref).norm() / d_ref.norm())
    gn_ref = float(met["grad_norm"])
    gn_rel = abs(float(grad_norm) - gn_ref) / gn_ref
    log(f"{tag} vs psum_dp from the same params and state: |d - "
        f"d_psum| / |d_psum| {rel!r} (<= 1e-5), max "
        f"{float((d_got - d_ref).abs().max())!r}; grad norm "
        f"{float(grad_norm)!r} vs {gn_ref!r}, relative {gn_rel!r} "
        f"(<= 1e-5)")
    assert rel <= 1e-5, (tag, rel)
    assert gn_rel <= 1e-5, (tag, gn_rel)
    return rel, gn_rel


def phase_zero1(dev):
    """ZeRO-1, the fault runtime, checkpoints and the recovery loop at full
    width on the 4x4 torus.  Every counted run is set to 0 just before it
    and read just after; returns ``{run: {kernel: launches}}``.

    1. ``--zero1`` for 3 steps: the first step held to psum_dp's; one
       more step with telemetry, its allgathered rows identical.
    2. ``--zero1 --quantize-grads`` for 2 steps: finite, the int8 wire
       launched; one more step with telemetry, its rows identical.
    3. Driven from Python through the striped fault runtime: 2 healthy
       steps, a link of tree 0 killed (flip to its degraded class, mu and
       nu resharded, there and back bit for bit), 2 steps, a flip back
       and 1 step; every step held to a psum_dp step from the same params
       and state; after each entry's first run a flip builds no stripe
       binding, no fabric index tensor and no reshard index.
    4. ``--zero1 --ckpt-dir`` for 2 steps, resumed to 3: equal to run 1 bit
       for bit; the step-2 checkpoint restored onto entry 0's and onto
       degraded/tree0's element maps, the second equal to
       ``reshard_owned`` of the first.
    5. ``--sync edst --recover`` for 2 steps (the first held to psum_dp's),
       then the probe with a link of tree 0 masked fed to the controller
       until it flips, and one step on the flipped entry held to psum_dp.
    6. Seconds per warm step of zero1 and of the striped engine (run just
       before and after it), the reduce-scatter / allgather split, the
       time of a reshard, a checkpoint save and restore, peak memory."""
    import torch
    from repro_torch import configs
    from repro_torch.ckpt import restore_sharded, save_sharded_checkpoint
    from repro_torch.core.collectives import (owner_element_map,
                                              striped_tables)
    from repro_torch.core.fault import FailureEvent
    from repro_torch.data import SyntheticLMStream
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.steps import (edst_spec_for_mesh,
                                        fault_runtime_for_mesh,
                                        make_train_step)
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
    base = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
            "--log-every", "1", "--device", "cuda", "--mesh", "4,4,1"]
    cfg = configs.get("smollm-135m")
    stream = SyntheticLMStream(cfg.vocab, 256, 32, seed=0)

    def batch(step):
        return {"tokens": torch.as_tensor(stream.batch(step),
                                          dtype=torch.long, device=dev)}

    per_run = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def run(tag, extra, keep=False):
        reset_all()
        t0 = time.perf_counter()
        res = train.main(base + extra, keep_first_step=keep)
        torch.cuda.synchronize()
        per_run[tag] = counts()
        assert all(math.isfinite(v) for v in res.losses), (tag, res.losses)
        log(f"train {tag}: losses {res.losses}, grad norms "
            f"{res.grad_norms}, s/step {res.step_seconds}, "
            f"{time.perf_counter() - t0!r}s in all, launches "
            f"{per_run[tag]}")
        return res

    def rows_identical(tag, res, quantize=False):
        """One more zero1 step from ``res``'s final state, built with
        telemetry (the default step compares nothing): every vertex row of
        its allgathered params must equal every other, bit for bit."""
        step = make_train_step(cfg, AdamW(cosine_schedule(3e-4, 20, 100)),
                               TORUS_MESH, MESH_NAMES, zero1=True,
                               engine="striped", quantize=quantize,
                               telemetry=True)
        reset_all()
        met = step(res.params, res.opt_state, batch(len(res.losses)))[2]
        torch.cuda.synchronize()
        per_run[tag] = counts()
        assert met["ag_replicas_equal"], f"{tag}: allgathered rows differ"

    # 1. --zero1, the first step against psum_dp's from the same init; the
    # striped engine's steps before and after it, for the warm step times
    striped = ["--sync", "edst", "--edst-engine", "striped", "--steps", "2"]
    before = run("edst striped torus4x4 (before zero1)", striped)
    z1 = run("zero1 torus4x4", ["--zero1", "--steps", "3"], keep=True)
    after = run("edst striped torus4x4 (after zero1)", striped)
    warm = {"striped before": before.step_seconds[1:],
            "zero1": z1.step_seconds[1:],
            "striped after": after.step_seconds[1:]}
    del before, after
    rows_identical("zero1 torus4x4 rows check", z1)
    assert per_run["zero1 torus4x4"]["tree_combine"] > 0
    opt3 = AdamW(cosine_schedule(3e-4, 20, 3))
    _held_to_psum("zero1 step 1", z1.init_params, opt3.init(z1.init_params),
                  batch(0), z1.first_step_params, z1.grad_norms[0], opt3)
    del z1.init_params, z1.first_step_params
    log(f"zero1: allgathered params identical on all {N_VERT} vertex rows "
        f"(bit for bit); warm s/step in turns: {warm}")

    # 2. the int8 gradient wire
    q = run("zero1+q8 torus4x4", ["--zero1", "--quantize-grads",
                                  "--steps", "2"])
    c = per_run["zero1+q8 torus4x4"]
    assert c["q8_pack_rows"] > 0 and c["q8_unpack_rows"] > 0, c
    rows_identical("zero1+q8 torus4x4 rows check", q, quantize=True)
    del q

    # 3. a link kill through the fault runtime, driven from Python
    rt = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES, engine="striped")
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    zstep = make_train_step(cfg, opt, TORUS_MESH, MESH_NAMES, zero1=True,
                            fault_runtime=rt, telemetry=True)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = ShardedAdamW(opt).init_for(params, rt, N_VERT)
    dead = sorted(rt.entries[0].sched.trees[0].tree)[0]
    sid_d = rt.on_failure(FailureEvent(links=frozenset({dead})),
                          prefer="degraded").active
    created = []
    orig_perm = StackedFabric._perm

    def spy(self, perm):
        if perm not in self._perms:
            created.append(perm)
        return orig_perm(self, perm)

    StackedFabric._perm = spy
    try:
        seen, bindings, reshards, n_created = {}, None, None, None
        schedule = (0, 0, sid_d, sid_d, 0)
        for i, sid in enumerate(schedule):
            if i and sid != schedule[i - 1]:
                frm = schedule[i - 1]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mu = rt.reshard_owned(state.mu, frm, sid, N_PARAMS)
                torch.cuda.synchronize()
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
                nu = rt.reshard_owned(state.nu, frm, sid, N_PARAMS)
                torch.cuda.synchronize()
                t_warm = time.perf_counter() - t0
                back = rt.reshard_owned(mu, sid, frm, N_PARAMS)
                assert torch.equal(back, state.mu), "reshard is not exact"
                del back
                log(f"zero1 flip {frm} -> {sid} ({rt.entries[sid].name}): "
                    f"reshard_owned of mu {t_first!r}s (first call), of "
                    f"nu {t_warm!r}s; there and back equals mu bit for bit")
                state = type(state)(state.step, mu, nu)
                del mu, nu
            dense = _dense_state(state.step, state.mu, state.nu,
                                 rt.zero1_element_map(N_PARAMS, sid), params)
            tag = f"zero1 torus4x4 fault runtime step {i + 1}"
            reset_all()
            t0 = time.perf_counter()
            new_params, new_state, met = zstep(params, state, batch(i), sid)
            torch.cuda.synchronize()
            per_run[tag] = counts()
            assert met["ag_replicas_equal"], tag
            log(f"{tag} on {rt.entries[sid].name}: loss "
                f"{float(met['loss'])!r}, {time.perf_counter() - t0!r}s, "
                f"launches {per_run[tag]}")
            _held_to_psum(f"zero1 fault runtime step {i + 1} "
                          f"({rt.entries[sid].name})", params, dense,
                          batch(i), new_params, met["grad_norm"], opt)
            del dense
            params, state = new_params, new_state
            seen[sid] = True
            if bindings is not None:
                # both entries had run: this flip and step built nothing
                assert striped_tables.cache_info().misses == bindings, \
                    "a flip bound a new stripe table"
                assert len(created) == n_created, "a flip built an index"
                assert len(rt._reshard_cache) == reshards
            elif all(seen.get(j) for j in (0, sid_d)):
                bindings = striped_tables.cache_info().misses
                n_created = len(created)
                reshards = len(rt._reshard_cache)
        assert bindings is not None
    finally:
        StackedFabric._perm = orig_perm
    log(f"zero1 fault runtime: after both entries' first runs the flips "
        f"built 0 stripe bindings, 0 fabric index tensors, 0 reshard "
        f"indices ({len(rt._reshard_cache)} cached)")

    # the split of a zero1 sync: the reduce-scatter and the allgather
    rs, _, ag = rt.make_zero1_sync()
    fabric = StackedFabric(N_VERT, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    grads = torch.randn((N_VERT, N_PARAMS), generator=g, device=dev)
    split = {}
    for sid in (0, sid_d):
        rs(grads, sid, fabric)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        owned = rs(grads, sid, fabric)
        torch.cuda.synchronize()
        t_rs = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = ag(owned, sid, (N_PARAMS,), fabric)
        torch.cuda.synchronize()
        t_ag = time.perf_counter() - t0
        del rows, owned
        e = rt.entries[sid]
        waves = len(striped_tables(e.spec, N_PARAMS, e.fractions).rs_waves)
        split[e.name] = (t_rs, t_ag)
        log(f"zero1 sync on {e.name}: reduce-scatter {t_rs!r}s ({waves} "
            f"waves), allgather {t_ag!r}s")
    del grads, params, state, new_params, new_state
    torch.cuda.empty_cache()

    # 4. checkpoints: 2 steps saved every step, resumed to 3
    ck = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        run("zero1 torus4x4 ckpt", ["--zero1", "--steps", "2", "--ckpt-dir",
                                    str(ck), "--ckpt-every", "1"])
        res = run("zero1 torus4x4 resumed", ["--zero1", "--steps", "3",
                                             "--ckpt-dir", str(ck)])
        assert res.start_step == 2 and len(res.losses) == 1
        same_p = torch.equal(flat_of(res.params), flat_of(z1.params))
        same_m = torch.equal(res.opt_state.mu, z1.opt_state.mu) and \
            torch.equal(res.opt_state.nu, z1.opt_state.nu)
        log(f"zero1 resumed at step 2 to 3 against the uninterrupted 3 "
            f"steps: params equal {same_p}, moments equal {same_m}, loss "
            f"{res.losses[0]!r} vs {z1.losses[2]!r}")
        assert same_p and same_m, "the resumed run differs"
        del res
        # timing of one save and one restore, on run 1's final state
        spec = edst_spec_for_mesh(TORUS_MESH, MESH_NAMES, engine="striped")
        emap = owner_element_map(spec, N_PARAMS)
        timing = ROOT / "build" / "ckpt_timing"
        shutil.rmtree(timing, ignore_errors=True)
        t0 = time.perf_counter()
        save_sharded_checkpoint(str(timing), 3, z1.params, z1.opt_state,
                                emap, N_PARAMS)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        p3, st3, _, _ = restore_sharded(str(timing), z1.params, emap)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        assert torch.equal(st3.mu, z1.opt_state.mu) and \
            torch.equal(flat_of(p3), flat_of(z1.params))
        del p3, st3
        shutil.rmtree(timing, ignore_errors=True)
        # the step-2 checkpoint onto entry 0's and degraded/tree0's maps
        # (the resumed run kept the newest two: steps 2 and 3)
        on0 = restore_sharded(str(ck), z1.params,
                              rt.zero1_element_map(N_PARAMS, 0), step=2)[1]
        on1 = restore_sharded(str(ck), z1.params,
                              rt.zero1_element_map(N_PARAMS, 1), step=2)[1]
        moved = rt.reshard_owned(on0.mu, 0, 1, N_PARAMS)
        ok = torch.equal(on1.mu, moved) and torch.equal(
            on1.nu, rt.reshard_owned(on0.nu, 0, 1, N_PARAMS))
        log(f"checkpoint: sharded save {t_save!r}s, restore {t_restore!r}s "
            f"(params + moments, 16 shards, CRC32 checked); the step-2 "
            f"checkpoint restored onto {rt.entries[1].name}'s element map "
            f"equals reshard_owned of it restored onto entry 0's: {ok}")
        assert ok, "restore onto the degraded map differs from reshard"
        del on0, on1, moved
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    del z1
    torch.cuda.empty_cache()

    # 5. the recovery loop: --recover, then a masked link until the flip
    rec = run("edst torus4x4 recover", ["--sync", "edst", "--recover",
                                        "--steps", "2"], keep=True)
    opt2 = AdamW(cosine_schedule(3e-4, 20, 2))
    _held_to_psum("zero1 recover step 1 (dense edst on entry 0)",
                  rec.init_params, opt2.init(rec.init_params), batch(0),
                  rec.first_step_params, rec.grad_norms[0], opt2)
    del rec.init_params, rec.first_step_params
    ctrl, mon = rec.controller, rec.monitor
    assert ctrl.schedule_id == 0 and not ctrl.journal
    s, d = sorted(ctrl.runtime.entries[0].sched.trees[0].tree)[0]
    mask = [0.0 if link == (s, d) else 1.0 for link in mon.links]
    for tick in range(2, 6):
        dec = ctrl.observe(mon.check(tick, fault_mask=mask))
        log(f"recover tick {tick}: link {(s, d)} masked -> {dec.action} "
            f"(schedule {dec.schedule_id}) {dec.detail}")
        if dec.action == "flip":
            break
    assert dec.action == "flip" and ctrl.schedule_id != 0
    for row in ctrl.journal_rows():
        log(f"recover journal: {json.dumps(row)}")
    step_fn = make_train_step(cfg, opt2, TORUS_MESH, MESH_NAMES,
                              mode="edst", fault_runtime=ctrl.runtime,
                              telemetry=True)
    tag = "edst torus4x4 recover flipped"
    reset_all()
    new_params, _, met = step_fn(rec.params, rec.opt_state, batch(2),
                                 ctrl.schedule_id)
    torch.cuda.synchronize()
    per_run[tag] = counts()
    log(f"{tag} on {ctrl.runtime.entry.name}: loss {float(met['loss'])!r}, "
        f"sync_dev {met['sync_dev']!r}, launches {per_run[tag]}")
    assert met["sync_dev"] == 0.0 and per_run[tag]["tree_combine"] > 0
    _held_to_psum(f"zero1 recover step 3 ({ctrl.runtime.entry.name})",
                  rec.params, rec.opt_state, batch(2), new_params,
                  met["grad_norm"], opt2)
    del rec, new_params
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    log(f"zero1 phase peak memory: {peak / 1e9:.2f} GB (limit 60)")
    assert peak < 60e9, peak
    return per_run


# ---------------------------------------------------------------------------
# the closed fault loop and the elastic rescale
# ---------------------------------------------------------------------------

def lost_node():
    """The seeded vertex the Roskind-Tarjan rescale drops."""
    import numpy as np
    return int(np.random.RandomState(LOST_SEED).randint(N_VERT))


def rescaled_runtime():
    """The torus's dense fault runtime rescaled onto the 15 survivors of
    ``lost_node()`` (``rescale_after_node_loss`` caches it)."""
    from repro_torch.core.fault import FailureEvent
    from repro_torch.dist.steps import fault_runtime_for_mesh
    from repro_torch.launch.elastic import rescale_after_node_loss
    torus = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES)
    return rescale_after_node_loss(
        torus, FailureEvent(nodes=frozenset({lost_node()})))[0]


def flat_of(tree):
    import torch
    from repro_torch.optim.adamw import tree_leaves
    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])


def phase_elastic(dev):
    """The fault loop closed at full width: the static verifier on the
    path's specs, the chaos loop ending in a rescale, the elastic CLI,
    the Roskind-Tarjan rescale onto 15 survivors, and the failure drill.
    Every counted run is set to 0 just before it and read just after;
    returns ``{run: {kernel: launches}}``.

    1. ``verify_spec(level="full")`` on every entry of the torus's
       pipelined and striped fault runtimes, every engine's spec of the
       ring 16, and every entry of the 15-vertex rescaled runtime and of
       the 2x4 torus's: all ``ok``, each timed, and one ``"cheap"``
       verify of the torus's pipelined spec.
    2. ``elastic.chaos_loop`` on the torus (every recovery's first step
       held to psum_dp, the corruption redo and the restore bit for bit,
       every kind fired, no unhandled exception), ending on the 2x4
       torus.
    3. ``launch.elastic`` on the node-loss checkpoint (``--to-mesh
       2,4,1``: the restored state bit for bit, k = 1), then
       ``launch.train --mesh 2,4,1 --ckpt-dir`` for 2 steps (the first
       held to psum_dp on the 2x4 torus, both losses the loop's own for
       those batches bit for bit), and again with
       ``--quantize-grads`` (the 2x4 torus's int8 reduce hops run
       ``q8_combine``).
    4. ``rescale_after_node_loss`` onto the 15 survivors of
       ``lost_node()``: entry 0's allreduce of a random (15,
       134,515,008) f32 payload and over the int8 wire, timed as
       ``phase_allreduce`` times; a second call returns the cached
       entries.
    5. ``failure_drill`` (link, burst, node) on the torus runtime: every
       ``sim_ok``, and every entry of each rung's runtime proven by the
       static verifier.
    Peak memory under 60 GB."""
    import torch
    from repro_torch import configs
    from repro_torch.analysis.verify import verify_spec
    from repro_torch.core.fault import FailureEvent
    from repro_torch.data import SyntheticLMStream
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.steps import fault_runtime_for_mesh
    from repro_torch.launch import elastic, train
    from repro_torch.optim import AdamW, cosine_schedule
    t_phase = time.perf_counter()
    cfg = configs.get("smollm-135m")
    per_run = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1. the static verifier on every spec the phase runs
    torus = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES)
    rt15 = rescaled_runtime()
    rt8 = fault_runtime_for_mesh(RESUME_MESH, MESH_NAMES)
    specs = [(f"torus4x4 pipelined {e.name}", e.spec) for e in torus.entries]
    specs += [(f"torus4x4 striped {e.name}", e.spec) for e in
              fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES,
                                     engine="striped").entries]
    ring = engine_specs(FABRICS["ring16"])
    specs += [(f"ring16 {eng}", ring[eng]) for eng in
              ("per_tree", "fused", "pipelined", "striped")]
    specs += [(f"rescaled15 {e.name}", e.spec) for e in rt15.entries]
    specs += [(f"torus2x4 {e.name}", e.spec) for e in rt8.entries]
    verify_s = []
    for tag, spec in specs:
        t0 = time.perf_counter()
        rep = verify_spec(spec, level="full")
        verify_s.append(time.perf_counter() - t0)
        log(f"verify {tag}: {rep.summary()} in {verify_s[-1]!r}s")
        assert rep.ok, (tag, rep.summary())
    t0 = time.perf_counter()
    rep = verify_spec(torus.entries[0].spec, level="cheap")
    t_cheap = time.perf_counter() - t0
    assert rep.ok
    log(f"verify: {len(specs)} specs at the full level in "
        f"{sum(verify_s)!r}s (max {max(verify_s)!r}s); the torus's "
        f"pipelined spec at the cheap level in {t_cheap!r}s")

    # 2. the closed chaos loop, ending on the 2x4 torus
    ck = ROOT / "build" / "ckpt_elastic"
    ck_q = ROOT / "build" / "ckpt_elastic_q8"
    for d in (ck, ck_q):
        shutil.rmtree(d, ignore_errors=True)

    def check(tag, params, opt_state, batch, new_params, grad_norm, mesh,
              opt):
        return _held_to_psum(tag, params, opt_state, batch, new_params,
                             grad_norm, opt, mesh=mesh)

    try:
        reset_all()
        t0 = time.perf_counter()
        res = elastic.chaos_loop(dev, cfg, 32, 256, str(ck), check, say=log)
        torch.cuda.synchronize()
        per_run["elastic chaos loop"] = c = counts()
        t_loop = time.perf_counter() - t0
        for row in res["journal"]:
            log(f"chaos journal: {json.dumps(row)}")
        for row in res["journal"]:
            log(f"chaos event: {row['cause']} -> {row['action']}, MTTR "
                f"{row['steps_degraded']} ticks, {row['mttr_s']!r}s")
        log(f"chaos loop: {len(res['commits'])} steps committed in "
            f"{res['ticks']} ticks, {res['steps_lost']} lost, "
            f"{res['unhandled']} unhandled, fired {res['fired']}, ends on "
            f"{res['mesh']}, {len(res['checks'])} recoveries held to "
            f"psum_dp, {t_loop!r}s in all, s/step {res['step_seconds']}, "
            f"launches {c}")
        assert res["unhandled"] == 0, "unhandled exception in the loop"
        assert sorted(res["fired"]) == sorted(res["kinds"]), res["fired"]
        assert res["redo_equal"] is True, "the corruption redo differs"
        assert res["restore_equal"] is True, "the loop's restore differs"
        assert res["mesh"] == RESUME_MESH, res["mesh"]
        assert len(res["checks"]) >= 5, res["checks"]
        assert c["tree_combine"] > 0, c
        saved = res.pop("saved")
        s = saved["step"]
        loop_losses = res["commits"][s:s + 2]
        assert len(loop_losses) == 2, (s, res["commits"])
        del res

        # 3. the elastic CLI on the node-loss checkpoint, and the resume
        shutil.copytree(ck, ck_q)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            params, opt_state, step = elastic.main(
                ["--ckpt-dir", str(ck), "--to-mesh", "2,4,1",
                 "--arch", "smollm-135m"])
        printed = out.getvalue().strip()
        exact = step == s and elastic.same_state(
            params, opt_state, saved["params"], saved["opt_state"])
        log(f"elastic CLI: {printed!r}; restored equal to the state saved "
            f"bit for bit: {exact}")
        assert exact and printed.endswith("k=1 trees"), printed
        del saved
        base = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
                "--log-every", "1", "--device", "cuda", "--mesh", "2,4,1",
                "--sync", "edst", "--steps", str(s + 2)]
        for tag, extra, d in (("elastic resume torus2x4", [], ck),
                              ("elastic resume torus2x4 q8",
                               ["--quantize-grads"], ck_q)):
            reset_all()
            t0 = time.perf_counter()
            r = train.main(base + extra + ["--ckpt-dir", str(d)],
                           keep_first_step=True)
            torch.cuda.synchronize()
            per_run[tag] = c = counts()
            log(f"{tag}: resumed at {r.start_step}, losses {r.losses}, "
                f"s/step {r.step_seconds}, {time.perf_counter() - t0!r}s, "
                f"launches {c}")
            assert r.start_step == s and len(r.losses) == 2
            assert all(math.isfinite(v) for v in r.losses), r.losses
            if extra:   # k = 1: every int8 reduce hop is a sole_add
                assert c["q8_pack_rows"] > 0 and c["q8_combine_rows"] > 0 \
                    and c["q8_unpack_rows"] > 0, c
            else:
                assert c["tree_combine"] > 0, c
                assert r.losses == loop_losses, (r.losses, loop_losses)
                opt = AdamW(cosine_schedule(3e-4, 20, s + 2))
                batch = {"tokens": torch.as_tensor(
                    SyntheticLMStream(cfg.vocab, 256, 32, seed=0).batch(s),
                    dtype=torch.long, device=dev)}
                _held_to_psum(f"{tag} step {s}", params, opt_state, batch,
                              r.first_step_params, r.grad_norms[0], opt,
                              mesh=RESUME_MESH)
                del batch
            del r
        del params, opt_state
    finally:
        for d in (ck, ck_q):
            shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()

    # 4. Roskind-Tarjan onto the 15 survivors, through its allreduce
    v = lost_node()
    again, relabel = elastic.rescale_after_node_loss(
        torus, FailureEvent(nodes=frozenset({v})))
    assert again.entries is rt15.entries, "the rescale was not cached"
    n15 = rt15.graph.n
    log(f"rescale: vertex {v} lost, {n15} survivors ({len(relabel)} "
        f"relabelled), {len(rt15.graph.edges)} edges, k={rt15.k}, depth "
        f"{rt15.entry.depth}, fractions {rt15.entry.fractions}; a second "
        f"call returns the cached entries")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n15, N_PARAMS), generator=g, device=dev)
    expect = x.sum(0)
    emax = float(expect.abs().max())
    sabs = float(x.abs().sum(0).max())
    fabric = StackedFabric(n15, dev)
    for quantize in (False, True):
        allreduce = rt15.make_allreduce(quantize=quantize)
        secs, y = [], None
        for i in range(2):  # the first call also grows the memory pool
            y = None
            torch.cuda.synchronize()
            if i:
                reset_all()
            t0 = time.perf_counter()
            y = allreduce(x, 0, fabric)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        tag = f"elastic allreduce rescaled15 {'int8' if quantize else 'f32'}"
        per_run[tag] = c = counts()
        err = max(float((y[r] - expect).abs().max()) for r in range(n15))
        same = bool((y == y[0]).all())
        tol = n15 * sabs / 254.0 if quantize else 1e-4 * emax
        del y
        log(f"{tag}: k={rt15.k} {secs[0]!r}s then {secs[1]!r}s, max|err| "
            f"{err:.3g} <= {tol:.3g}, rows identical {same}, launches {c}")
        assert err <= tol and same, (tag, err, tol, same)
        assert c["tree_combine"] > 0, c
        if quantize:
            assert c["q8_pack_rows"] > 0 and c["q8_unpack_rows"] > 0, c
        torch.cuda.empty_cache()
    del x, expect
    torch.cuda.empty_cache()

    # 5. the failure drill, each rung's runtime proven statically
    t0 = time.perf_counter()
    report = elastic.failure_drill(torus, n_events=3,
                                   kinds=("link", "burst", "node"))
    for rec in report["events"]:
        if rec["kind"] == "link":
            event = FailureEvent(links=frozenset({tuple(rec["dead_link"])}))
            rt = (torus.on_failure(event) if rec["schedule"] != "with_rebuild"
                  else torus.with_rebuild(event))
        elif rec["kind"] == "burst":
            rt = torus.with_rebuild(FailureEvent(
                links=frozenset(tuple(e) for e in rec["dead_links"])))
        else:
            rt = elastic.rescale_after_node_loss(torus, FailureEvent(
                nodes=frozenset({rec["dead_node"]})))[0]
        static = [rt.verify_entry(i, static=True)
                  for i, e in enumerate(rt.entries) if e.k > 0]
        rec["static_ok"] = all(static)
        assert rec["sim_ok"] and rec["static_ok"], rec
    log(f"failure drill ({time.perf_counter() - t0!r}s, every entry of "
        f"each rung's runtime verified): {json.dumps(report)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"elastic phase: {time.perf_counter() - t_phase!r}s, peak memory "
        f"{peak / 1e9:.2f} GB (limit 60)")
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
    per_run.update(phase_zero1(dev))
    per_run.update(phase_elastic(dev))
    launches = {name: sum(c[name] for c in per_run.values())
                for name in counts()}
    log(f"launches over the allreduce, training, serving, zero1 and "
        f"elastic runs: "
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
