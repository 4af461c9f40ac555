#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's four kernel libraries (tree-combine / int8 wire codec,
flash attention, RG-LRU scan, WKV6) from the sources in this checkout,
one ``nvcc`` per source, all at once; holds each kernel against its plain
PyTorch version at ragged small shapes and at every shape its path gives
it, and times it (flash attention in bf16, on the tensor cores, at all
nine prefill layouts, full-mask and rectangular ones too, and in f32, on
the CUDA cores, at recurrentgemma-2b's; beside SDPA, and at the causal
ones without a window also SDPA's is_causal form; and its training
direction, the forward with the row log-sum-exp and the bf16 backward,
held element by element at smollm-135m's and olmoe-1b-7b's training
shapes, a window, a full mask and ragged S, and timed beside SDPA's
forward and backward); sums a
full-size stacked gradient with every EDST engine (per-tree, fused,
pipelined at 1 and 4 segments, striped; 4x4 torus f32 and int8, ring 16
int8); trains the full-width smollm-135m (10 of its 30 layers)
data-parallel over the 16
vertices of the 4x4 torus (attention on the flash kernels, each run's
calls counted; edst with each engine, edst + int8 wire,
psum_dp, and one profiled edst step whose trace it splits into the
sync's waves) and of the ring 16 (edst + int8 wire, the fabric whose
reduce hops run q8_combine); trains the full-width rwkv6-7b and
olmoe-1b-7b (1 layer each, 2x2 torus) and recurrentgemma-2b (3 layers, 2
vertices) through the same entry point and models/api.py, psum_dp, edst
(held to psum_dp), gspmd and, for rwkv6-7b, edst + int8 wire, and
profiles one edst step of each; and serves eight full-width models through
the serving entry point, bf16: recurrentgemma-2b (batch 8, prompt 4096),
smollm-135m (batch 8, prompt 1024) and rwkv6-7b (batch 8, prompt 4096),
32 greedy tokens each, and qwen2-7b (qkv bias), qwen3-8b (qk-norm),
mistral-nemo-12b, olmoe-1b-7b and qwen2-moe-a2.7b (GShard MoE), batch 8,
prompt 4096, 16 tokens each (flash attention at head_dim 128, also held
and timed at their three prefill layouts); and, through models/api.py
and their modules, seamless-m4t-large-v2 (batch 8, 4096 frames, prompt
4096; flash full-mask in the encoder and the cross-attention, causal in
the decoder) and internvl2-2b (batch 8, 1024 patches, prompt 3072; flash
causal at G = 2, D = 128), 16 tokens each; each model followed by an f32
check that a decode step's logits equal those of a prefill of the same
tokens; then trains
ZeRO-1 over the torus (held to psum_dp, over the int8 wire, through the
striped fault runtime with a link of tree 0 killed and the moments
resharded, checkpointed and resumed bit for bit, restored onto a
degraded element map) and runs the recovery loop (--recover, a masked
probe fed to the controller until it flips, a step on the flipped
entry held to psum_dp); then closes the fault loop (every spec of these
paths proven by the static verifier; a seeded chaos trace of flap, kill,
burst, straggler, corruption and node loss driving training on the
torus, smollm-135m at 10 of its 30 layers and full width, each recovery's first step held to psum_dp, the node loss
checkpointed and rescaled onto the 2x4 torus through the elastic entry
point, and training resumed there, f32 and int8; the Roskind-Tarjan
rescale onto all 15 survivors summing a (15, 134,515,008) payload; the
failure drill); last, the wave-level telemetry (every wave of the 4x4
and 2x8 tori's pipelined and striped programs timed on the card at 4 MiB
and at the full gradient beside the CostModel's prediction, the fitted
``cuda`` row, S = 1, 2, 4, 8 against ``segments="auto"``, a measured
trace and a ``--trace-out`` trace validated, no wave range without a
profiler, and the ranges' cost under one); last, the process-group
fabric: the torus allreduce (pipelined and striped, f32 and int8), the
edst training (its warm step timed stacked, NCCL, NCCL, stacked), ZeRO-1
(f32 and int8), the fault runtime's flip with reshard_owned, the sharded
checkpoint resumed, the recovery loop and the wave timer over a world-1
NCCL group, each bit for bit with the stacked fabric's run, gspmd with
every parameter a DTensor on the group's (1, 1) data x model mesh held
to a stacked gspmd run (its warm step, the program analyser's per-device
counts of that step, its roofline terms and measured roofline share),
GPipe over smollm-135m's layers on both fabrics, and the reduced training
(edst and zero1) and a masked probe's flip over 4 gloo ranks on the host
(multi-rank NCCL where the machine has two or more cards); after every
timed phase of the card, gspmd over 4 gloo ranks on the host with a real
(2, 2) data x model mesh (tensor-parallel over model, FSDP over data) for
the reduced smollm-135m, qwen3-8b, rwkv6-7b, olmoe-1b-7b and
recurrentgemma-2b, each held to a stacked gspmd run.  Beside the card's
phases, one subprocess dry-runs smollm-135m's and recurrentgemma-2b's
train_4k cells and rwkv6-7b's long_500k cell on a fake 16 x 16 group of
256 ranks on the host (``repro_torch.launch.dryrun``: each must exit 0,
fit in 80 GB and issue collectives).  Beside
WKV6's row it logs where the kernel's time goes ("wkv6 parts": copies
with one part of its chunk loop compiled out, and mma.sync TF32 alone).
Every failed check raises, so the exit code is non-zero and no result
line is printed.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

preceded by one JSON line ``{"kernels": [...]}`` (launches summed over
the runs of each kernel's path, an allreduce, training, serving or the
wave-by-wave timer, each run counted from 0 just before it and read just
after it, and by phase in ``launches_by_phase``; times from
CUDA events in
this run, each the median of 5 rounds of about 20 ms of back-to-back
calls) and the card's name and power limit from nvidia-smi.

It needs a CUDA device and the repository around it; without either it
exits non-zero.
"""
from __future__ import annotations

import contextlib
import functools
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
# the reference telemetry bench's fabrics (benchmarks/telemetry_bench.py
# FABRICS) and payloads: its DEFAULT_ELEMS f32 (4 MiB a vertex) and the
# full smollm-135m gradient
TELEMETRY_TORI = {"torus4x4": (4, 4), "torus2x8": (2, 8)}
TELEMETRY_NBYTES = (4 << 20, 4 * N_PARAMS)
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
    gradients, every reduce hop ``sole_add``). The telemetry path adds,
    on each of its tori at each of its payloads, the pipelined S=1 reduce
    hop (all 16 chunk rows in one combine: on the 2x8 torus (k = 1) at
    full width 16 x 134,515,008 elements, more than 2^31) and the striped
    program's widest reduce window."""
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
    for dims in TELEMETRY_TORI.values():
        specs = engine_specs(dims)
        for nbytes in TELEMETRY_NBYTES:
            size = nbytes // 4
            hop = (N_VERT, -(-size // specs["pipelined"].k))
            if hop != (N_VERT, M_ROW) and hop not in hops:  # M_ROW: timed
                hops.append(hop)
            window = _widest_reduce_window(
                striped_tables(specs["striped"], size))
            if window not in windows:
                windows.append(window)
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
            ("tree_combine at a reduce hop", rows_, m)
        del part, recv
    torch.cuda.empty_cache()
    log(f"kernels: tree_combine at the S=4 segments {engine_shapes[:2]}, "
        f"the striped windows {windows} and the elastic and telemetry "
        f"reduce hops {hops} matches the plain version bit for bit")

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


# (b, s, t, h, kv, d, causal, window), queries at 0..s-1 over keys at
# 0..t-1: the reference's five kernel-test cases, then the serving
# layouts at ragged lengths; last, the encdec and vlm layouts: full
# (non-causal) with s < t and s > t, and a ragged t, and causal at G = 2,
# D = 128 (internvl2-2b)
FLASH_SMALL = ((2, 128, 128, 8, 2, 64, True, None),
               (1, 100, 100, 4, 4, 32, True, None),
               (2, 256, 256, 8, 1, 128, True, 48),
               (1, 128, 128, 2, 2, 64, False, None),
               (1, 64, 64, 4, 2, 128, True, None),
               (2, 333, 333, 10, 1, 256, True, 100),
               (3, 301, 301, 9, 3, 64, True, None),
               (2, 40, 40, 10, 1, 256, True, None),
               (2, 129, 129, 10, 1, 256, True, 65),
               (2, 127, 127, 9, 3, 64, True, 63),
               (1, 191, 191, 10, 1, 128, True, 1),
               (1, 65, 65, 4, 2, 32, True, 64),
               (2, 77, 77, 14, 2, 128, True, None),
               (1, 300, 300, 28, 4, 128, True, None),
               (2, 77, 128, 16, 16, 64, False, None),
               (2, 129, 64, 8, 8, 64, False, None),
               (1, 50, 333, 4, 4, 64, False, None),
               (1, 200, 1024, 16, 16, 64, False, None),
               (2, 301, 301, 16, 8, 128, True, None))
# the prefill attention of each served model: (b, s, t, h, kv, d, causal,
# window); qwen3-8b's layout is mistral-nemo-12b's, olmoe-1b-7b's
# qwen2-moe-a2.7b's; seamless-m4t-large-v2's encoder and cross-attention
# run the full mask (the same call: 4096 decoder tokens over 4096 frames)
FLASH_PATH = {"recurrentgemma-2b": (8, 4096, 4096, 10, 1, 256, True, 2048),
              "smollm-135m": (8, 1024, 1024, 9, 3, 64, True, None),
              "qwen2-7b": (8, 4096, 4096, 28, 4, 128, True, None),
              "qwen3-8b / mistral-nemo-12b": (8, 4096, 4096, 32, 8, 128, True,
                                              None),
              "olmoe-1b-7b / qwen2-moe-a2.7b": (8, 4096, 4096, 16, 16, 128,
                                                True, None),
              "seamless-m4t-large-v2 encoder": (8, 4096, 4096, 16, 16, 64,
                                                False, None),
              "seamless-m4t-large-v2 cross": (8, 4096, 4096, 16, 16, 64,
                                              False, None),
              "seamless-m4t-large-v2 decoder self": (8, 4096, 4096, 16, 16,
                                                     64, True, None),
              "internvl2-2b": (8, 4096, 4096, 16, 8, 128, True, None)}
# (batch, prompt, generated tokens) served per model; the prompt of the
# MoE models is a multiple of their groups (256, 512), which keeps the f32
# decode check exact (see f32_decode_check)
SERVE = {"recurrentgemma-2b": (8, 4096, 32), "smollm-135m": (8, 1024, 32),
         "rwkv6-7b": (8, 4096, 32), "qwen2-7b": (8, 4096, 16),
         "qwen3-8b": (8, 4096, 16), "mistral-nemo-12b": (8, 4096, 16),
         "olmoe-1b-7b": (8, 4096, 16), "qwen2-moe-a2.7b": (8, 4096, 16)}
# the encoder-decoder and VLM served through models/api.py and their
# modules (launch/serve.py, as the reference's, serves decoder-only archs):
# (batch, frames or patches, text prompt, generated tokens); the encoder
# reads ENC_LEN_FOR_DECODE frames, and internvl2-2b's n_img_tokens patches
# and its 3072-token text make the reference's 4096 prefill positions
MM_SERVE = {"seamless-m4t-large-v2": (8, 4096, 4096, 16),
            "internvl2-2b": (8, 1024, 3072, 16)}
# the lm models held to the f32 check's limit with the bf16 KV cache too
# (the others log that gap; see f32_decode_check)
BF16_CACHE_HELD = ("smollm-135m",)
RG_SCAN = (8, 4096, 2560)      # one RG-LRU layer's scan in that prefill
# the counted run's launches: one prefill (decode runs no kernel)
PATH_LAUNCHES = {
    "recurrentgemma-2b": {"flash_attention": 8, "rglru_scan": 18, "wkv6": 0},
    "smollm-135m": {"flash_attention": 30, "rglru_scan": 0, "wkv6": 0},
    "rwkv6-7b": {"flash_attention": 0, "rglru_scan": 0, "wkv6": 32},
    **{arch: {"flash_attention": n, "rglru_scan": 0, "wkv6": 0}
       for arch, n in (("qwen2-7b", 28), ("qwen3-8b", 36),
                       ("mistral-nemo-12b", 40), ("olmoe-1b-7b", 16),
                       ("qwen2-moe-a2.7b", 24),
                       # encoder 24 + decoder self 24 + cross 24
                       ("seamless-m4t-large-v2", 72), ("internvl2-2b", 24))}}
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

    def qkv(b, s, t, h, kv, d, dt):
        return (torch.randn((b, n_, n, d), generator=g, device=dev).to(dt)
                for n_, n in ((s, h), (t, kv), (t, kv)))

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

    for b, s, t, h, kv, d, causal, window in FLASH_SMALL:
        for dt in (torch.float32, torch.bfloat16):
            check(*qkv(b, s, t, h, kv, d, dt), causal, window, b, s, t, h,
                  kv, d)
    torch.cuda.synchronize()
    log("flash_attention: ragged shapes match the plain version")

    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    replaces = "src/repro/kernels/flash_attention/kernel.py:85"
    timings = {}
    for arch, (b, s, t, h, kv, d, causal, window) in FLASH_PATH.items():
        # bf16 on the tensor-core kernel at every shape, and f32 on the
        # CUDA-core kernel at recurrentgemma-2b's
        for dt in ((torch.bfloat16, torch.float32)
                   if arch == "recurrentgemma-2b" else (torch.bfloat16,)):
            q, k, v = qkv(b, s, t, h, kv, d, dt)
            err, share = check(q, k, v, causal, window, arch)
            torch.cuda.empty_cache()
            mask = None         # full: SDPA without a mask is the function
            if causal:
                pos = torch.arange(s, device=dev)
                mask = pos[None, :] <= pos[:, None]
                if window:
                    mask &= pos[None, :] > pos[:, None] - window
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
            ops = 4 * b * h * d * (live_pairs(s, window) if causal else s * t)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            log(f"flash_attention at {arch}'s prefill {tuple(q.shape)} / "
                f"{tuple(k.shape)} {name}, "
                f"{'causal' if causal else 'full'}, window {window}: "
                f"{ops:.4g} operations; max|err| {err!r}"
                + (f", {share!r} of the per-element bound" if share else ""))
            row = timed_row(
                "flash_attention", src, replaces, err,
                lambda: FK.flash_attention(q, k, v, causal=causal,
                                           window=window),
                lambda: attention_ref(q, k, v, causal=causal, window=window),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True),
                nbytes, ops,
                BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
            if causal and not window:
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


# the training attention of the benchmark's two train cells, (b, s, h, kv,
# d), causal: smollm-135m's per-vertex call (16 x 2048, 9 heads over 3)
# and olmoe-1b-7b's (4 x 4096, 16 over 16)
FLASH_TRAIN = {"smollm-135m": (16, 2048, 9, 3, 64),
               "olmoe-1b-7b": (4, 4096, 16, 16, 128)}
# (b, s, h, kv, d, causal, window): the backward with a window, a full
# mask and S not a multiple of its 64-key tiles
FLASH_BWD_SMALL = ((2, 333, 6, 2, 64, True, 100),
                   (2, 512, 4, 2, 128, False, None),
                   (3, 77, 9, 3, 32, True, None),
                   (2, 130, 4, 1, 128, True, 65))


def phase_flash_train(dev):
    """The training direction of flash attention: the forward with the row
    log-sum-exp and the bf16 backward, at :data:`FLASH_BWD_SMALL` and at
    the train cells' shapes (:data:`FLASH_TRAIN`).  The forward's output
    bit for bit the serving forward's, its lse within 5e-5 of the plain
    version's; dq, dk and dv element by element within
    ``ref.py::bf16_bwd_bound`` around ``ref.py::attention_bwd_ref`` (at
    the train shapes one batch row at a time); a second backward bit for
    bit the first.  Returns the ``flash_attention_lse`` and
    ``flash_attention_bwd`` rows at smollm-135m's shape, olmoe-1b-7b's
    under ``other_shapes``: bounds 4 d and 10 d operations a live (query,
    key) pair over the bf16 peak (the backward computes the scores and
    dP twice, 14 d); library SDPA's forward, and its forward and backward
    under autograd; beside the backward, the kernels' forward and
    backward through autograd (``fwd_bwd_ms``) and the blockwise
    ``layers.sdpa``'s, as training ran before them
    (``blockwise_sdpa_fwd_bwd_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                          attention_ref_lse,
                                                          bf16_bwd_bound)
    from repro_torch.models import layers as L
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(3)

    def inputs(b, s, h, kv, d):
        return [torch.randn((b, s, n, d), generator=g, device=dev)
                .to(torch.bfloat16) for n in (h, kv, kv, h)]

    def check(q, k, v, dout, causal, window, *where):
        """Returns out, lse, (dq, dk, dv), the largest |error| of dq, dk
        and dv and the largest share of their bound."""
        out, lse = FK.flash_attention(q, k, v, causal=causal, window=window,
                                      lse=True)
        grads = FK.flash_attention_bwd(q, k, v, out, dout, lse,
                                       causal=causal, window=window)
        assert torch.equal(out, FK.flash_attention(
            q, k, v, causal=causal, window=window)), ("lse moved the "
                                                      "output", *where)
        again = FK.flash_attention_bwd(q, k, v, out, dout, lse,
                                       causal=causal, window=window)
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, again)), (
            "flash_attention_bwd not deterministic", *where)
        del again
        worst = share = lse_err = 0.0
        for i in range(q.shape[0]):
            x = [t[i:i + 1] for t in (q, k, v, out, dout, lse)]
            _, lse_ref = attention_ref_lse(*(t.float() for t in x[:3]),
                                           causal=causal, window=window)
            lse_err = max(lse_err, float((x[5] - lse_ref).abs().max()))
            del lse_ref
            ref = attention_bwd_ref(*x, causal=causal, window=window)
            bounds = bf16_bwd_bound(*x, ref, causal=causal, window=window)
            for name, got, want, bound in zip(("dq", "dk", "dv"), grads,
                                              ref, bounds):
                err = (got[i:i + 1].float() - want).abs_()
                assert bool(torch.isfinite(err).all()), (name, *where)
                worst = max(worst, float(err.max()))
                share = max(share, float(err.div_(bound).max()))
            del ref, bounds
        assert lse_err < 5e-5, ("flash_attention lse", *where, lse_err)
        assert share <= 1.0, ("flash_attention_bwd over its per-element "
                              "bound", *where, share)
        return out, lse, grads, worst, share, lse_err

    for b, s, h, kv, d, causal, window in FLASH_BWD_SMALL:
        q, k, v, dout = inputs(b, s, h, kv, d)
        check(q, k, v, dout, causal, window, b, s, h, kv, d)
    torch.cuda.synchronize()
    log("flash_attention_bwd: window, full and ragged shapes within the "
        "bound of their roundings, bit for bit twice")

    src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    # the reference trains through jax.grad of its blockwise sdpa
    replaces = "src/repro/models/layers.py:301"
    rows = {"flash_attention_lse": {}, "flash_attention_bwd": {}}
    for arch, (b, s, h, kv, d) in FLASH_TRAIN.items():
        q, k, v, dout = inputs(b, s, h, kv, d)
        out, lse, grads, err, share, lse_err = check(q, k, v, dout, True,
                                                     None, arch)
        del grads
        torch.cuda.empty_cache()
        pairs = b * h * live_pairs(s, None)
        qkv = sum(x.numel() * x.element_size() for x in (q, k, v))
        o = out.numel() * out.element_size()
        log(f"flash_attention_bwd at {arch}'s training {tuple(q.shape)} / "
            f"{tuple(k.shape)} bf16, causal: {10 * d * pairs:.4g} "
            f"operations; max|err| {err!r}, {share!r} of the per-element "
            f"bound; lse max|err| {lse_err!r}")
        qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        leaves_t = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

        def grad_of(fn, xs, dy):
            return lambda: torch.autograd.grad(fn(*xs), xs, dy)

        row = timed_row(
            "flash_attention_lse", src, replaces, lse_err,
            lambda: FK.flash_attention(q, k, v, lse=True),
            lambda: attention_ref_lse(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            qkv + o + lse.numel() * 4, 4 * d * pairs, BF16_OPS_PER_S)
        rows["flash_attention_lse"][arch] = row
        row = timed_row(
            "flash_attention_bwd", src, replaces, err,
            lambda: FK.flash_attention_bwd(q, k, v, out, dout, lse),
            lambda: attention_bwd_ref(q, k, v, out, dout, lse),
            grad_of(lambda *x: F.scaled_dot_product_attention(
                *x, is_causal=True, enable_gqa=True), leaves_t, dt),
            # q, k, v, out, dout and lse in; dq, dk, dv out; rowsum(dO o O)
            # written and read
            2 * qkv + 2 * o + 3 * lse.numel() * 4, 10 * d * pairs,
            BF16_OPS_PER_S)
        row["bound_share"] = share
        row["fwd_bwd_ms"] = timed(grad_of(fops.attention, leaves, dout))
        cfg = L.AttnCfg(d_model=h * d, n_heads=h, n_kv=kv, head_dim=d)
        pos = torch.arange(s, device=dev)
        row["blockwise_sdpa_fwd_bwd_ms"] = timed(grad_of(
            lambda *x: L.sdpa(*x, pos, pos, cfg), leaves, dout), rounds=3)
        log(f"flash_attention at {arch}'s training: forward and backward "
            f"through autograd {row['fwd_bwd_ms']:.3f} ms, the blockwise "
            f"sdpa's {row['blockwise_sdpa_fwd_bwd_ms']:.3f} ms")
        rows["flash_attention_bwd"][arch] = row
        del q, k, v, dout, out, lse, qt, kt, vt, dt, leaves, leaves_t
        torch.cuda.empty_cache()
    out = []
    for by_arch in rows.values():
        row = by_arch.pop("smollm-135m")
        row["shape"] = "smollm-135m train bf16"
        row["other_shapes"] = {f"{arch} train bf16": {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_share", "fwd_bwd_ms",
            "blockwise_sdpa_fwd_bwd_ms") if key in r}
            for arch, r in by_arch.items()}
        out.append(row)
    return out


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


def sync_launches(c):
    """The sync's kernel launches (tree_combine and the int8 codec) among
    the counts ``c``: a gspmd run launches none of them, while its models
    may launch their own (flash attention's forward and backward)."""
    return sum(c[name] for name in libraries()["tree_combine"].LAUNCHES)


def attention_counts(argv, layers, on_kernels):
    """The training attention counters that a run of ``train.main(argv)``
    with ``layers`` attention layers and remat on reads: a pass (each
    vertex's batch a step; under gspmd the whole batch a step) runs each
    layer's forward twice (the forward and remat's recompute) and its
    backward once.  On the kernels each forward is the forward with the
    row lse; elsewhere each counts in ``attention_sdpa_train``."""
    def opt(name):
        return argv[argv.index(name) + 1]
    vertices = 1 if opt("--sync") == "gspmd" else math.prod(
        int(n) for n in opt("--mesh").split(","))
    calls = 2 * int(opt("--steps")) * vertices * layers
    return {"flash_attention_lse": calls if on_kernels else 0,
            "flash_attention_bwd": calls // 2 if on_kernels else 0,
            "attention_sdpa_train": 0 if on_kernels else calls}


def held_attention(tag, c, argv, layers, on_kernels, only=False):
    """Assert the counts ``c`` of a training run: its attention counters
    as :func:`attention_counts` gives them, and with ``only`` every other
    counter 0."""
    want = attention_counts(argv, layers, on_kernels)
    if only:
        want = {**dict.fromkeys(c, 0), **want}
    assert {k: c[k] for k in want} == want, (tag, c, want)


@contextlib.contextmanager
def layer_readout():
    """While open, every transformer (and encdec decoder) layer's output
    at the last position goes to ``rec["x"]`` and every MoE router's
    chosen experts to ``rec["idx"]``, for the f32 check's per-layer log.
    It wraps ``transformer._block``, ``encdec._dec_block`` and
    ``moe.route`` for its duration."""
    from repro_torch.models import encdec, moe, transformer as T
    rec = {"x": [], "idx": []}
    block, dec_block, route = T._block, encdec._dec_block, moe.route

    def readout(fn):
        def wrapped(*args, **kw):
            out, extra = fn(*args, **kw)
            rec["x"].append(out[:, -1].clone())
            return out, extra
        return wrapped

    def _route(*args):
        r = route(*args)
        rec["idx"].append(r[3].clone())     # a view of the whole sort
        return r

    T._block, encdec._dec_block = readout(block), readout(dec_block)
    moe.route = _route
    try:
        yield rec
    finally:
        T._block, encdec._dec_block, moe.route = block, dec_block, route


def mm_prefill(cfg, model, params, src, prompts, gen, cache_dtype):
    """The prefill an encdec or vlm server runs, through ``model``
    (``api.build(cfg)``) and the family's module, every attention on the
    flash kernel: for encdec ``encode``, ``cross_kv`` and ``decode`` into
    a fresh ``cache_dtype`` self cache at ``cache_len`` 0; for vlm
    ``forward`` of the patches ``src`` and the prompts into a fresh cache.
    Returns the last logits (B, vocab_padded) and the decode state."""
    from repro_torch.models import encdec, vlm
    b, n = prompts.shape
    if cfg.family == "encdec":
        enc = encdec.encode(cfg, params, src, fresh=True)
        ckv = encdec.cross_kv(cfg, params, enc)
        del enc
        cache = encdec.init_cache(cfg, b, n + gen, dtype=cache_dtype,
                                  device=src.device)
        logits, cache = encdec.decode(cfg, params, prompts, self_cache=cache,
                                      cache_len=0, ckv=ckv, last_only=True,
                                      fresh=True)
        return logits[:, -1], (cache, ckv)
    n_img = src.shape[1]
    cache = vlm.init_cache(cfg, b, n_img + n + gen, dtype=cache_dtype,
                           device=src.device)
    logits, cache = vlm.forward(cfg, params, prompts, src, cache=cache,
                                cache_len=0, last_only=True, fresh=True)
    return logits[:, -1], (cache, n_img)


def mm_decode(cfg, model, params, state, tok, n):
    """One greedy step through ``model.decode_fn``: ``tok`` (B, 1) the
    text token at position ``n``.  Returns the logits and the state."""
    cache, extra = state
    if cfg.family == "encdec":
        logits, cache = model.decode_fn(params, cache, {
            "tokens": tok, "cache_len": n, "cross_k": extra[0],
            "cross_v": extra[1]})
    else:
        logits, cache = model.decode_fn(params, cache, {
            "tokens": tok, "cache_len": extra + n})
    return logits, (cache, extra)


def mm_serve(cfg, model, params, src, prompts, gen):
    """Serve one batch as ``launch/serve.py`` does: the prefill, then
    ``gen - 1`` greedy decode steps, bf16 caches; returns ``(tokens,
    prefill seconds, decode tok/s, last logits)``."""
    import torch
    b, n = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = mm_prefill(cfg, model, params, src, prompts, gen,
                               torch.bfloat16)
    tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, state = mm_decode(cfg, model, params, state, tok, n + i)
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = (gen - 1) * b / dt if gen > 1 else 0.0
    return torch.cat(out, dim=1), prefill_s, rate, logits


def f32_decode_check(dev, arch, prompt):
    """At full width in f32: prefill ``prompt`` tokens, decode one, and
    hold the decode's logits (plain attention over the cache, one plain
    recurrence step) against the last logits of a prefill of the same
    ``prompt + 1`` tokens (the kernels).  The two sum in different orders
    (kernel tiles against a one-block softmax, a sequential scan or the
    chunked WKV against one step, other matmul shapes).  On an H100 that
    reorder gave 1.4e-5 (recurrentgemma-2b), 2.5e-6 (smollm-135m) and
    2.4e-5 (rwkv6-7b) of the largest logit, so the limit is 1e-4 of it:
    7, 40 and 4 times those readings; with the f32 cache below, 4.9e-6
    to 5.6e-6 (qwen2-7b, qwen3-8b, mistral-nemo-12b), 1.97e-5
    (olmoe-1b-7b) and 6.90e-5 (qwen2-moe-a2.7b, 1.45 times under it).
    The encdec and vlm models (``MM_SERVE``) prefill as they are served
    (:func:`mm_prefill`, the cache filled at ``cache_len`` 0) and, with
    the f32 cache, hold the decode step to ``api.prefill_fn`` of the
    longer prompt, the cache-less prefill, with the same frames or
    patches: for seamless-m4t-large-v2 its cross-attention runs 4097
    decoder tokens over 4096 frames.  On an H100 80GB HBM3 at 700 W:
    1.5e-6 (seamless-m4t-large-v2) and 8.9e-6 (internvl2-2b) of the
    largest logit.

    The lm, moe, encdec and vlm families run it twice: with an f32 KV
    cache, and with the bf16 one that serving writes.  The two prefills'
    matmuls of different lengths may round a prompt key's last f32 bits
    apart, and a bf16 cache can turn that into one-ulp flips that add up
    layer by layer; so with the bf16 cache only the models of
    ``BF16_CACHE_HELD`` are held to the limit and the others' gap is
    logged, and with the f32 cache every model is held to it.  Each run
    logs, layer by layer, the gap between the new token's hidden states in
    the decode and in the second prefill.  For the MoE models ``prompt`` is
    a multiple of the group size: the first ``prompt`` tokens form the same
    groups in both prefills, and the new token heads a group of its own and
    keeps every choice, as in decode's group of one.  The routing is not the
    same in the two prefills all the same: their products run at other
    shapes, and a prompt token near a tie tips to another expert, with its
    group's drops.  On an H100 qwen2-moe-a2.7b's f32 run tipped 1 of the
    32768 prompt tokens at layer 0 and 420 at layer 23, and the new token's
    hidden-state gap grew from 3.3e-6 to 7.5e-5 of its largest;
    olmoe-1b-7b's tipped none.  Each run logs, per layer, the prompt tokens
    routed differently in the two prefills and the new tokens routed
    differently in the decode and the second prefill."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import model_fns
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get(arch), act_dtype_name="float32")
    model = api.build(cfg)
    mm = cfg.family in ("encdec", "vlm")
    b = (MM_SERVE[arch] if mm else SERVE[arch])[0]

    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        if mm:
            _, n_src, _, _ = MM_SERVE[arch]
            src = torch.randn((b, n_src, cfg.d_model), generator=gen,
                              device=dev)
            key = "frames" if cfg.family == "encdec" else "patches"
        prompts = torch.randint(0, cfg.vocab, (b, prompt), generator=gen,
                                device=dev)
        if mm:
            def prefill_with(dtype):
                def prefill(params, tokens, _):
                    return mm_prefill(cfg, model, params, src, tokens, 1,
                                      dtype)
                return prefill

            def decode(params, state, tok, n):
                return mm_decode(cfg, model, params, state, tok, n)

            def cacheless(params, tokens, _):
                return model.prefill_fn(params, {key: src, "tokens": tokens})
            # (what the run's KV cache holds, its prefill, the prefill of
            # the longer prompt, held to the limit): with the f32 cache
            # the cache-less prefill; with the bf16 one, as for the lm
            # models, the served prefill, whose fresh keys round through
            # the cache's dtype as the decode's cached ones do
            served = prefill_with(torch.bfloat16)
            runs = (("f32 cache", prefill_with(torch.float32), cacheless,
                     True),
                    ("bf16 cache", served, served, False))
        else:
            served_prefill, decode = model_fns(cfg)

            def f32_cache_prefill(params, tokens, max_len):
                """``T.prefill`` with an f32 cache."""
                cache = T.init_cache(cfg, tokens.shape[0], max_len,
                                     dtype=torch.float32, device=dev)
                logits = T.forward(cfg, params, tokens, cache=cache,
                                   cache_len=0, last_only=True)
                return logits[:, -1], cache

            runs = ((("f32 cache", f32_cache_prefill, f32_cache_prefill,
                      True),
                     ("bf16 cache", served_prefill, served_prefill,
                      arch in BF16_CACHE_HELD))
                    if cfg.family in ("lm", "moe")
                    else (("", served_prefill, served_prefill, True),))
        for cache, prefill, full, held in runs:
            tag = f"f32 check {arch}" + (f", {cache}" if cache else "")
            torch.cuda.reset_peak_memory_stats()
            with layer_readout() as first:
                logits, caches = prefill(params, prompts, prompt + 1)
            tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
            with layer_readout() as step:
                dec = decode(params, caches, tok, prompt)[0]
            del caches
            with layer_readout() as second:
                full_logits = full(params, torch.cat([prompts, tok], 1),
                                   prompt + 1)[0]
            dec, full_logits = dec[:, :cfg.vocab], full_logits[:, :cfg.vocab]
            err = max_err(dec, full_logits)
            scale = float(full_logits.abs().max())
            same = bool((dec.argmax(-1) == full_logits.argmax(-1)).all())
            tol = 1e-4 * max(1.0, scale)
            log(f"{tag}: decode at {prompt} vs prefill of {prompt + 1}: "
                f"max|dlogit| {err!r} {'<=' if err <= tol else '>'} {tol!r} "
                f"(1e-4 * max(1, max|logit| {scale!r}); "
                f"{'held' if held else 'logged, not held'}), greedy tokens "
                f"equal {same}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            if step["x"]:
                gaps = [float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(step["x"], second["x"])]
                log(f"{tag}: the new token's hidden-state gap after each "
                    f"layer (of its largest): "
                    + " ".join(f"{g:.2e}" for g in gaps))
            if first["idx"]:
                ng = first["idx"][0].shape[1]
                moved = [int((x != y[:, :ng]).any(-1).sum())
                         for x, y in zip(first["idx"], second["idx"])]
                new = [int((x.reshape(b, -1) != y[:, ng, 0]).any(-1).sum())
                       for x, y in zip(step["idx"], second["idx"])]
                log(f"{tag}: prompt tokens (of {b * prompt}) whose experts "
                    f"differ in the two prefills, by layer: {moved}; new "
                    f"tokens (of {b}) whose experts differ in the decode "
                    f"and the second prefill: {new}")
            del first, step, second
            torch.cuda.empty_cache()
            if held:
                assert math.isfinite(err) and err <= tol, (tag, err, tol)
    del params
    torch.cuda.empty_cache()


def phase_serve(dev):
    """Full-width serving through the entry point, one run per model, each
    counted from 0 just before it and read just after; then the f32 check
    of each.  The encdec and vlm models (``MM_SERVE``), which the entry
    point refuses as the reference's does, are served by :func:`mm_serve`
    through ``models/api.py`` and their modules.  Each counted run follows
    an uncounted one at the same shape (one token), so its prefill is
    timed warm: the memory pool already grown and each matmul shape's
    first cuBLAS call behind it.  Returns ``{run: {kernel: launches}}``."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api
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
    for arch, (batch, n_src, prompt, gen) in MM_SERVE.items():
        cfg = configs.get(arch)
        model = api.build(cfg)
        torch.cuda.empty_cache()
        with torch.inference_mode():
            params = model.init(torch.Generator(device=dev).manual_seed(0),
                                dev)
            g = torch.Generator(device=dev).manual_seed(1)
            src = torch.randn((batch, n_src, cfg.d_model), generator=g,
                              device=dev, dtype=torch.bfloat16)
            prompts = torch.randint(0, cfg.vocab, (batch, prompt),
                                    generator=g, device=dev)
            cold = mm_serve(cfg, model, params, src, prompts, 1)[1]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_all()
            t0 = time.perf_counter()
            tokens, prefill_s, rate, last = mm_serve(cfg, model, params, src,
                                                     prompts, gen)
            torch.cuda.synchronize()
        tag = f"serve {arch}"
        per_run[tag] = c = counts()
        peak = torch.cuda.max_memory_allocated()
        what = "frames" if cfg.family == "encdec" else "patches"
        log(f"{tag}: batch {batch} x {n_src} {what} + prompt {prompt}, {gen} "
            f"tokens, bf16, api.build + {cfg.family} modules: prefill "
            f"{prefill_s!r}s warm, {cold!r}s cold "
            f"({batch * (n_src + prompt) / prefill_s!r} positions/s warm), "
            f"decode {rate!r} tok/s, peak memory {peak / 1e9:.2f} GB, "
            f"{time.perf_counter() - t0:.1f}s in all, launches {c}")
        log(f"{tag}: first row {tokens[0].tolist()}")
        assert tuple(tokens.shape) == (batch, gen), tokens.shape
        assert bool(torch.isfinite(last.float()).all()), tag
        for name, n in PATH_LAUNCHES[arch].items():
            assert c[name] == n, (tag, name, c[name], n)
        del params, src, prompts, tokens, last
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


# phase_train's and phase_fabric's smollm-135m training depth: full width,
# 10 of its 30 layers.  At all 30 the smoke read 1132.8 s of the 1200 s
# limit (PERF.md) before the gspmd DTensor runs and the dry run were added;
# every check of both phases is kept
TRAIN_LAYERS = 10


def train_cfg():
    """smollm-135m (remat on, as in the full config) cut to
    ``TRAIN_LAYERS`` layers."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get("smollm-135m"),
                               n_layers=TRAIN_LAYERS)


def phase_train(dev):
    """Full-width smollm-135m (``TRAIN_LAYERS`` deep) through the training
    entry point, one run per path, every attention call on the flash
    kernels (:func:`held_attention`).  Every launch counter is set to 0
    just before each run and read just after it; returns ``{run: {kernel:
    launches}}``."""
    import torch
    from repro_torch.launch import train
    base = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
            "--log-every", "1", "--device", "cuda"]
    per_run = {}
    torch.cuda.reset_peak_memory_stats()

    def run(tag, extra, keep=False):
        reset_all()
        t0 = time.perf_counter()
        res = train.main(base + extra, keep_first_step=keep,
                         cfg=train_cfg())
        torch.cuda.synchronize()
        per_run[tag] = counts()
        dt = time.perf_counter() - t0
        assert all(math.isfinite(v) for v in res.losses), (tag, res.losses)
        held_attention(tag, per_run[tag], base + extra, TRAIN_LAYERS, True)
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


# the process-group fabric (phase_fabric): the torus cells it runs at full
# width on a world-1 NCCL group, the reduced training the gloo ranks run on
# the host, and the pipeline's cut of smollm-135m's 30 layers
FABRIC_CELLS = (("pipelined", "off"), ("striped", "off"),
                ("pipelined", "full"), ("striped", "full"))
GLOO_RANKS = 4
FABRIC_TRAIN = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
                "--mesh", "4,4,1", "--log-every", "1"]
# (--sync, --steps): phase_train's profiled edst run and its psum_dp run
FABRIC_SYNCS = (("edst", "2"), ("psum_dp", "1"))
# the peak of a world-1 run may exceed the stacked one's by this much (a
# process-group step that held (n, P) more would be 8.6 GB over)
FABRIC_PEAK_SLACK = 64 << 20
GLOO_TRAIN = ["--reduced", "--steps", "2", "--batch", "16", "--seq", "16",
              "--mesh", "4,4,1", "--sync", "edst", "--device", "cpu",
              "--log-every", "1"]
GLOO_ZERO1 = ["--reduced", "--steps", "2", "--batch", "16", "--seq", "16",
              "--mesh", "4,4,1", "--zero1", "--device", "cpu",
              "--log-every", "1"]
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_SEQ = 6, 8, 4, 256
PIPE_TIMED = ("sequential", "stacked", "nccl-1", "nccl-1", "stacked")
RANK_JOIN_S = 300


def spawn_ranks(target, world, args):
    """Run ``target(rank, world, init, out_dir, *args)`` on ``world``
    spawned processes sharing a ``file://`` store in a temporary
    directory, each joined with its own timeout (a hang fails the phase);
    returns each rank's ``rank{r}.pt``."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{Path(tmp) / 'store'}"
        procs = [ctx.Process(target=target, args=(r, world, init, tmp, *args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RANK_JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not hung, ("ranks still running", hung, RANK_JOIN_S)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, ("rank exit codes", codes)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def torchrun_env(rank, world):
    """The variables ``torchrun`` sets that ``launch/train.py`` reads."""
    import os
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))


def gloo_train_rank(rank, world, init, out_dir):
    """One gloo rank of the host check: ``GLOO_TRAIN`` through
    ``train.main`` under torchrun's environment."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.set_num_threads(1)
    torchrun_env(rank, world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = train.main(GLOO_TRAIN)
        out = {"losses": res.losses, "params": flat_of(res.params)}
        res = train.main(GLOO_ZERO1)
        out["zero1"] = {"losses": res.losses, "params": flat_of(res.params),
                        "mu": res.opt_state.mu, "nu": res.opt_state.nu}
        out["probe"] = masked_probe_flip(rank)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def masked_probe_flip(rank=None):
    """The probe of the 4x4 torus's fault runtime with a link of tree 0
    masked, fed to a recovery controller until it flips: ``(tick,
    schedule id, journal rows)``.  Over gloo ranks (``rank`` given) the
    mask is applied on the rank that receives over the link only; the
    probe's ``all_reduce`` tells every other rank, and every rank must
    flip alike.  Stacked when ``rank`` is None."""
    from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
    from repro_torch.dist.health import HealthMonitor
    from repro_torch.dist.recovery import RecoveryController
    from repro_torch.dist.steps import fault_runtime_for_mesh
    rt = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES)
    fabric = StackedFabric(N_VERT, "cpu") if rank is None \
        else ProcessGroupFabric(N_VERT, "cpu")
    mon = HealthMonitor(fabric, rt)
    ctrl = RecoveryController(rt, clock=mon.clock, agree=fabric.all_true)
    link = sorted(rt.entries[0].sched.trees[0].tree)[0]
    mask = [0.0 if lk == link else 1.0 for lk in mon.links] \
        if fabric.owns(link[1]) else None
    for tick in range(4):
        if ctrl.observe(mon.check(tick, fault_mask=mask)).action == "flip":
            break
    return tick, ctrl.schedule_id, ctrl.journal_rows()


def zero1_rank(rank, world, init, out_dir):
    """One NCCL rank on ``cuda:rank`` of a multi-card zero1 step:
    ``train.main`` at full width, 1 step, each rank holding its block's
    moments."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torchrun_env(rank, world)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world, device_id=dev)
    try:
        res = train.main(FABRIC_ZERO1 + ["--zero1", "--steps", "1"],
                         cfg=zero1_cfg())
        torch.save({"losses": res.losses, "grad_norms": res.grad_norms,
                    "params": flat_of(res.params).cpu(),
                    "rows": tuple(res.opt_state.mu.shape)},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def allreduce_rank(rank, world, init, out_dir, width):
    """One NCCL rank on ``cuda:rank`` of a multi-card allreduce: its block
    of rows of the 4x4 torus payload ``(16, width)`` through pipelined S=1
    on the process-group fabric, against the stacked engine on the same
    card."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world, device_id=dev)
    try:
        spec = engine_specs((4, 4))["pipelined"]
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((N_VERT, width), generator=g, device=dev)
        want = run_engine("pipelined", x, spec, StackedFabric(N_VERT, dev),
                          "off")
        fabric = ProcessGroupFabric(N_VERT, dev)
        mine = x[fabric.lo:fabric.hi].contiguous()
        del x
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_engine("pipelined", mine, spec, fabric, "off")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        torch.save({"equal": torch.equal(got, want[fabric.lo:fabric.hi]),
                    "rows": (fabric.lo, fabric.hi), "seconds": secs},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def pipeline_stages(dev):
    """smollm-135m's layer body in f32 as ``pipeline_apply``'s stage:
    ``(stage_fn, stage_params, x, sequential)``, ``PIPE_STAGES`` stages
    of its 30 layers, ``PIPE_MICRO`` random microbatches of ``PIPE_MB``
    x ``PIPE_SEQ`` hidden states, and ``sequential(x)``: the same
    microbatches through the 30 layers in order."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as TR
    from repro_torch.models.api import build
    cfg = dataclasses.replace(configs.get("smollm-135m"),
                              act_dtype_name="float32")
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             dev)
    per = cfg.n_layers // PIPE_STAGES
    layers = TR._unbind(params["layers"])
    stage_params = [layers[s * per:(s + 1) * per]
                    for s in range(PIPE_STAGES)]
    pos = torch.arange(PIPE_SEQ, device=dev)

    def run_layers(lps, h):
        for lp in lps:
            h, _ = TR._block(cfg, lp, h, pos)
        return h

    def stage_fn(local, h):
        return torch.stack([run_layers(local[i], h[i])
                            for i in range(h.shape[0])])

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.d_model),
                    generator=g, device=dev)

    def sequential(x):
        return torch.stack([run_layers(layers, xm) for xm in x])

    return stage_fn, stage_params, x, sequential


FABRIC_ZERO1 = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
                "--log-every", "1", "--device", "cuda", "--mesh", "4,4,1"]
FABRIC_WAVE_ITERS = 2


def same_ckpt_files(a, b):
    """Whether two sharded checkpoint steps hold the same files, each array
    equal, the manifests equal but for the shards' CRC32 (each npz holds
    its write time): ``(equal, files)``."""
    import numpy as np
    names = sorted(p.name for p in a.iterdir())
    if names != sorted(p.name for p in b.iterdir()):
        return False, names
    for name in names:
        if name == "manifest.json":
            ma, mb = (json.loads((d / name).read_text()) for d in (a, b))
            if set(ma["sharded"].pop("checksums")) != \
                    set(mb["sharded"].pop("checksums")) or ma != mb:
                return False, names
            continue
        with np.load(a / name) as x, np.load(b / name) as y:
            if sorted(x.files) != sorted(y.files) or not all(
                    np.array_equal(x[k], y[k]) for k in x.files):
                return False, names
    return True, names


def abba_turns(argv, abba):
    """The second half of the ABBA timing of the warm (second) edst
    training step: a world-1 NCCL run, then a stacked one, after the
    stacked and NCCL runs whose warm steps ``abba`` holds; logs all four
    and the pair means."""
    import os
    import torch
    from repro_torch.launch import train
    torchrun_env(0, 1)
    try:
        abba["nccl-1"].append(train.main(argv,
                                         cfg=train_cfg()).step_seconds[1])
    finally:
        for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(key)
    torch.cuda.empty_cache()
    abba["stacked"].append(train.main(argv, cfg=train_cfg()).step_seconds[1])
    torch.cuda.empty_cache()
    a, b = abba["stacked"], abba["nccl-1"]
    log(f"fabric nccl-1 train edst torus4x4 warm s/step in the order "
        f"stacked, NCCL, NCCL, stacked: {a[0]!r}, {b[0]!r}, {b[1]!r}, "
        f"{a[1]!r}; pair means stacked {sum(a) / 2!r}, world-1 NCCL "
        f"{sum(b) / 2!r} ({sum(b) / sum(a):.4f}x)")


GSPMD_TRAIN = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
               "--mesh", "1,1", "--sync", "gspmd", "--steps", "2",
               "--log-every", "1"]


def fabric_gspmd(dev, per_run):
    """``--sync gspmd`` over the world-1 NCCL group: ``train.main`` under
    torchrun's environment places every parameter of smollm-135m (full
    width, ``TRAIN_LAYERS`` deep) as a DTensor on the group's (1, 1) data x
    model mesh; held to a stacked gspmd run of the same seed (bit for bit
    expected; the grad norms within 1e-6 and the first step's move within
    1e-5 of its size at least), its peak within ``FABRIC_PEAK_SLACK`` of
    the stacked run's, its launches the stacked run's (the flash kernels'
    training calls, :func:`held_attention`, and no other).  Then one warm
    step of the same run timed, the
    program analyser's per-device counts of the next step, the roofline
    terms of those counts and the measured roofline share (model FLOPs
    over the bf16 peak, over the warm step).  Then the other token
    families the same way (:func:`fabric_gspmd_families`)."""
    import os
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.analysis.hlo import ProgramRecorder
    from repro_torch.analysis.roofline import (PEAK_FLOPS, model_flops_for,
                                               roofline)
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import train
    argv = GSPMD_TRAIN + ["--device", dev.type]
    cfg = train_cfg()
    reset_all()
    torch.cuda.reset_peak_memory_stats()
    ref = train.main(argv, keep_first_step=True, cfg=cfg)
    ref_peak = torch.cuda.max_memory_allocated()
    ref_c = counts()
    held_attention("stacked gspmd", ref_c, argv, TRAIN_LAYERS, True,
                   only=True)
    ref_p0, ref_p1 = flat_of(ref.init_params).cpu(), \
        flat_of(ref.first_step_params).cpu()
    ref_params, ref_losses, ref_gn = flat_of(ref.params).cpu(), \
        ref.losses, ref.grad_norms
    ref_secs = ref.step_seconds
    del ref
    torch.cuda.empty_cache()
    torchrun_env(0, 1)
    try:
        reset_all()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(argv, keep_first_step=True, cfg=cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        tag = "fabric nccl-1 train gspmd dtensor"
        per_run[tag] = c = counts()
        equal = res.losses == ref_losses and torch.equal(
            flat_of(res.params).cpu(), ref_params)
        gn = max(abs(a - b) / b for a, b in zip(res.grad_norms, ref_gn))
        d_ref = ref_p1 - ref_p0
        move = float((flat_of(res.first_step_params).cpu()
                      - flat_of(res.init_params).cpu() - d_ref).norm()
                     / d_ref.norm())
        log(f"{tag} (smollm-135m, {TRAIN_LAYERS} layers, 32 x 256, (1, 1) "
            f"mesh): losses {res.losses} (stacked {ref_losses}), grad "
            f"norms {res.grad_norms} (stacked {ref_gn}, relative {gn!r}), "
            f"first move off the stacked one by {move!r} of its size, "
            f"losses and parameters equal {equal}; s/step "
            f"{res.step_seconds} (stacked {ref_secs}); peak "
            f"{peak / 1e9:.4f} GB (stacked "
            f"{ref_peak / 1e9:.4f} GB), launches {c}")
        assert gn <= 1e-6, (tag, gn)
        assert equal or move <= 1e-5, (tag, move)
        assert peak <= ref_peak + FABRIC_PEAK_SLACK, (tag, peak, ref_peak)
        assert c == ref_c, (tag, c, ref_c)
        del res
        torch.cuda.empty_cache()

        # the warm step and the analyser's counts of the next one
        run, params, opt_state = train.setup(train.parser().parse_args(argv),
                                             cfg)
        leaves = train.tree_leaves(params)
        assert all(isinstance(p, DTensor) for p in leaves)
        mesh = leaves[0].device_mesh
        assert tuple(mesh.shape) == (1, 1), mesh
        params, opt_state, _ = run.step_fn(params, opt_state, run.batch(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = run.step_fn(params, opt_state, run.batch(1))
        float(met["loss"])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        with ProgramRecorder() as rec:
            run.step_fn(params, opt_state, run.batch(2))
            torch.cuda.synchronize()
        del params, opt_state, run
        st = rec.stats
        shape = ShapeSpec("smoke", 256, 32, "train")
        terms = roofline(cfg, shape, "1x1", 1, st.dot_flops,
                         st.bytes_touched, st.total_collective_bytes)
        mflops = model_flops_for(cfg, shape, 1)
        share = mflops / PEAK_FLOPS / warm
        log(f"{tag} warm step {warm!r} s; analyser per device: dot flops "
            f"{st.dot_flops!r}, bytes touched {st.bytes_touched!r}, "
            f"collective bytes {st.collective_bytes} counts "
            f"{st.collective_counts}; roofline terms: compute "
            f"{terms.compute_s!r} s, memory {terms.memory_s!r} s, "
            f"collective {terms.collective_s!r} s ({terms.dominant}-bound, "
            f"bound {terms.bound_s!r} s); model flops {mflops!r}, "
            f"measured roofline share model_flops / 989e12 / step "
            f"{share!r} ({share:.2%})")
        assert st.dot_flops > 0 and math.isfinite(warm)
        torch.cuda.empty_cache()
        fabric_gspmd_families(per_run)
    finally:
        for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(key)
    torch.cuda.empty_cache()


def fabric_gspmd_families(per_run):
    """``--sync gspmd`` with DTensor parameters for the other token
    families (``FAMILY_TRAIN``'s depths, full width, batch 8 x 256, 2
    steps) on the world-1 group's (1, 1) mesh, under torchrun's
    environment: each held to ``phase_train_families``' stacked gspmd run
    of the same seed and depth (``FAMILY_GSPMD_REF``): the same initial
    parameters, the first step's loss equal and its grad norm within
    1e-6, the first move bit for bit or within 1e-5 of its size, the
    second step's loss and grad norm within 1e-5 of the stacked ones (a
    move off by that much moves them by as little; the step's clip summed
    the squares of a transposed gradient, the tied embedding's, in another
    order until the gspmd step made its gradients contiguous, and a card
    may still choose other kernels for other layouts), the peak within
    ``FABRIC_PEAK_SLACK`` of the stacked run's,
    no sync kernel launched (:func:`sync_launches`) and every counter
    equal to the stacked run's; each warm step logged beside the stacked
    one."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    for arch, layers, _ in FAMILY_TRAIN:
        ref = FAMILY_GSPMD_REF.pop(arch)
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        argv = ["--arch", arch, "--batch", "8", "--seq", "256", "--mesh",
                "1,1", "--sync", "gspmd", "--steps", "2", "--log-every", "1",
                "--device", "cuda"]
        reset_all()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(argv, keep_first_step=True, cfg=cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        tag = f"fabric nccl-1 train gspmd dtensor {arch}"
        per_run[tag] = c = counts()
        p0 = flat_of(res.init_params).cpu()
        d = flat_of(res.first_step_params).cpu() - p0
        same_init = torch.equal(p0, ref["p0"])
        del p0
        move = float((d - ref["d"]).norm() / ref["d"].norm())
        moved_equal = torch.equal(d, ref["d"])
        del d
        gn = [abs(a - b) / b for a, b in zip(res.grad_norms,
                                             ref["grad_norms"])]
        dloss = abs(res.losses[1] - ref["losses"][1]) / ref["losses"][1]
        log(f"{tag} ({layers} of {configs.get(arch).n_layers} layers, 8 x "
            f"256, (1, 1) mesh): "
            f"losses {res.losses} (stacked {ref['losses']}), grad norms "
            f"{res.grad_norms} (stacked {ref['grad_norms']}, relative "
            f"{gn!r}; second loss relative {dloss!r}), first move off the "
            f"stacked one by {move!r} of its "
            f"size (bit for bit {moved_equal}); warm step "
            f"{res.step_seconds[1]!r} s beside stacked "
            f"{ref['step_seconds'][1]!r} s (s/step {res.step_seconds}, "
            f"stacked {ref['step_seconds']}); peak {peak / 1e9:.4f} GB "
            f"(stacked {ref['peak'] / 1e9:.4f} GB); launches {c}")
        assert same_init, f"{tag}: a different init"
        assert res.losses[0] == ref["losses"][0], (tag, res.losses)
        assert gn[0] <= 1e-6, (tag, gn)
        assert moved_equal or move <= 1e-5, (tag, move)
        assert max(gn[1], dloss) <= 1e-5, (tag, gn, dloss)
        assert peak <= ref["peak"] + FABRIC_PEAK_SLACK, (tag, peak,
                                                         ref["peak"])
        assert sync_launches(c) == 0, (tag, c)
        assert c == ref["launches"], (tag, c, ref["launches"])
        del res, ref
        torch.cuda.empty_cache()


# --sync gspmd over 4 gloo ranks on the host with a real model axis: the
# reduced configs of the five token families on a (2, 2) data x model mesh
GLOO_GSPMD_ARCHS = ("smollm-135m", "qwen3-8b", "rwkv6-7b", "olmoe-1b-7b",
                    "recurrentgemma-2b")
GLOO_GSPMD_MESH, GLOO_GSPMD_NAMES = (2, 2), ("data", "model")
GLOO_GSPMD_BATCH, GLOO_GSPMD_SEQ, GLOO_GSPMD_STEPS = 16, 16, 2
GLOO_GSPMD_AUX = ("moe_load_balance", "moe_router_z")


def gloo_gspmd_run(arch, mesh=None):
    """Two gspmd steps of the reduced ``arch`` from the seed-0 init on the
    seed-11 token batches: stacked (plain tensors, one process) without
    ``mesh``, else with DTensor parameters placed on ``mesh`` by
    ``dist/sharding.py`` (TP over ``model``, FSDP over ``data``).  Returns
    each step's metrics, the whole parameters after each step (flat), the
    first step's learning rate and, on a mesh, each parameter's local and
    ``spec_for`` shard shapes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.steps import full_values, make_train_step
    from repro_torch.models.api import build
    from repro_torch.optim import AdamW, cosine_schedule
    api = build(configs.get(arch).reduced())
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.RandomState(11).randint(
        0, api.cfg.vocab, (GLOO_GSPMD_STEPS, GLOO_GSPMD_BATCH,
                           GLOO_GSPMD_SEQ + 1))
    out = {"metrics": [], "params": []}
    if mesh is None:
        step = make_train_step(api, opt, GLOO_GSPMD_MESH, GLOO_GSPMD_NAMES,
                               mode="gspmd")
    else:
        sh = shd.tree_shardings(api.param_axes(), params, mesh, fsdp=True)
        params = shd.distribute(params, sh)
        out["shards"] = shd.map_axes(
            lambda a, p, s: (tuple(p.to_local().shape),
                             shd.local_shape(s.spec, p.shape, mesh)),
            api.param_axes(), params, sh)
        step = make_train_step(api, opt, GLOO_GSPMD_MESH, GLOO_GSPMD_NAMES,
                               mode="gspmd", group=dist.group.WORLD)
    state = opt.init(params)
    for i in range(GLOO_GSPMD_STEPS):
        params, state, met = step(params, state, {"tokens": torch.as_tensor(
            tokens[i], dtype=torch.long)})
        out["metrics"].append({k: float(v) for k, v in met.items()})
        out["params"].append(flat_of(full_values(params)))
    out["lr"] = out["metrics"][0]["lr"]
    return out


def gloo_gspmd_rank(rank, world, init, out_dir):
    """One gloo rank of ``phase_gloo_gspmd``: :func:`gloo_gspmd_run` of
    each family on the (2, 2) mesh, and the rank's kernel launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    torchrun_env(rank, world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(GLOO_GSPMD_MESH, GLOO_GSPMD_NAMES)
        reset_all()
        out = {arch: gloo_gspmd_run(arch, mesh) for arch in GLOO_GSPMD_ARCHS}
        out["launches"] = counts()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_gloo_gspmd(dev):
    """``--sync gspmd`` over 4 gloo ranks on the card's host with a real
    model axis: each family of ``GLOO_GSPMD_ARCHS`` (reduced), 2 steps of
    16 x 16 tokens on a (2, 2) data x model mesh (parameters placed by
    ``dist/sharding.py``: TP + FSDP), held to a stacked gspmd run of the
    same config and batches in this process, within the gloo tests'
    limits: each step's loss and xent within 1e-5, grad norm within 1e-5
    relative, the MoE's ``moe_load_balance`` and ``moe_router_z`` within
    1e-5; the first step's parameters within 2 lr + 1e-6 with under 1e-3
    of them beyond 1e-6; every rank's local shards shaped as ``spec_for``
    names, every rank ending with the same parameters, and no kernel
    launched (the ranks and the stacked runs are host tensors).  The
    ranks run through :func:`spawn_ranks` (a join timeout each).  Returns
    ``{run: {kernel: launches}}``: the stacked runs' and the ranks'."""
    del dev                                     # host tensors only
    import torch
    from repro_torch.optim.adamw import tree_leaves
    per_run = {}
    ref = {}
    t0 = time.perf_counter()
    for arch in GLOO_GSPMD_ARCHS:
        reset_all()
        ref[arch] = gloo_gspmd_run(arch)
        per_run[f"gloo gspmd stacked {arch}"] = counts()
    t1 = time.perf_counter()
    ranks = spawn_ranks(gloo_gspmd_rank, GLOO_RANKS, ())
    t2 = time.perf_counter()
    per_run["gloo gspmd ranks"] = {
        k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    for arch in GLOO_GSPMD_ARCHS:
        want = ref[arch]
        lr = want["lr"]
        gaps = []
        for r in ranks:
            got = r[arch]
            bad = [(a, s) for a, s in tree_leaves(got["shards"]) if a != s]
            assert not bad, (arch, "shards not as spec_for names", bad)
            for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
                assert set(g) == set(w), (arch, sorted(g), sorted(w))
                for k in ("loss", "xent") + tuple(
                        k for k in GLOO_GSPMD_AUX if k in w):
                    gaps.append((f"{k}{i}", abs(g[k] - w[k])))
                    assert abs(g[k] - w[k]) <= 1e-5, (arch, i, k, g[k], w[k])
                rel = abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                gaps.append((f"grad_norm{i} rel", rel))
                assert rel <= 1e-5, (arch, i, g["grad_norm"], w["grad_norm"])
            d = (got["params"][0] - want["params"][0]).abs()
            gaps += [("first step's params max |d|", float(d.max())),
                     ("their share beyond 1e-6",
                      float((d > 1e-6).float().mean()))]
            assert gaps[-2][1] <= 2 * lr + 1e-6, (arch, gaps[-2])
            assert gaps[-1][1] < 1e-3, (arch, gaps[-1])
            assert torch.equal(got["params"][-1], ranks[0][arch]["params"][-1])
        worst = {}
        for k, v in gaps:
            worst[k] = max(worst.get(k, 0.0), v)
        log(f"gloo gspmd {arch} (reduced, 4 ranks, {GLOO_GSPMD_MESH} "
            f"data x model, {GLOO_GSPMD_BATCH} x {GLOO_GSPMD_SEQ}): losses "
            f"{[m['loss'] for m in ranks[0][arch]['metrics']]} (stacked "
            f"{[m['loss'] for m in want['metrics']]}), grad norms "
            f"{[m['grad_norm'] for m in ranks[0][arch]['metrics']]} (stacked "
            f"{[m['grad_norm'] for m in want['metrics']]}); worst gaps over "
            f"the ranks {worst} (params' limit {2 * lr + 1e-6!r})")
    log(f"gloo gspmd: stacked runs {t1 - t0!r} s, 4 ranks {t2 - t1!r} s; "
        f"kernel launches {sum(sum(c.values()) for c in per_run.values())}")
    assert all(sum(c.values()) == 0 for c in per_run.values()), per_run
    return per_run


# the dry run's cells, one after the other in one host subprocess on a fake
# 16 x 16 group: an lm training cell, the recurrent decode cell, and the
# training cell whose backward torch 2.11 refused before the models'
# redistributions kept a partial sum's split gradient whole
DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("rwkv6-7b", "long_500k"),
                ("recurrentgemma-2b", "train_4k"))
DRYRUN_CODE = """
import json, sys
from repro_torch.launch.dryrun import run_cell
json.dump([run_cell(a, s, False) for a, s in CELLS], open(OUT, "w"))
"""


def start_dryrun():
    """One host subprocess: ``repro_torch.launch.dryrun.run_cell`` of each
    of ``DRYRUN_CELLS`` in turn on a fake 16 x 16 group (CPU only: it sees
    no card).  Returns ``(process, start, out file, end box)``; a thread
    stamps the end, so its seconds are its own wherever it is
    collected."""
    import os
    import threading
    out = ROOT / "build" / "dryrun_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", f"CELLS = {DRYRUN_CELLS!r}\n"
         f"OUT = {str(out)!r}\n" + DRYRUN_CODE], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    end = []
    threading.Thread(target=lambda: (proc.wait(),
                                     end.append(time.perf_counter())),
                     daemon=True).start()
    return proc, t0, out, end


def finish_dryrun(started):
    """Wait for :func:`start_dryrun`'s subprocess (600 s at most) and hold
    each cell: exit code 0, peak within 80 GB, collectives issued."""
    proc, t0, out, end = started
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
        raise AssertionError(("dry run did not end in 600 s", text[-3000:]))
    secs = (end[0] if end else time.perf_counter()) - t0
    lines = [ln for ln in text.splitlines() if ln.startswith(("[dryrun]",
                                                              "  "))]
    log("dryrun subprocess: " + " | ".join(lines))
    assert proc.returncode == 0, ("dry run failed", text[-3000:])
    cells = json.loads(out.read_text())
    assert [(c["arch"], c["shape"]) for c in cells] == list(DRYRUN_CELLS)
    for cell in cells:
        mem, coll = cell["memory"], cell["collectives"]
        log(f"dryrun {cell['arch']} {cell['shape']} on a fake 16x16 group: "
            f"trace {cell['trace_s']} s, peak "
            f"{mem['peak_bytes'] / 1e9:.3f} GB a device (fits "
            f"{cell['fits']}), dot flops {cell['flops']!r}, collective "
            f"counts {coll['counts']}, bytes {coll['total_bytes']!r}, "
            f"roofline {cell['roofline']}")
        assert cell["fits"] and mem["peak_bytes"] <= 80e9, mem
        assert sum(coll["counts"].values()) > 0, coll
    log(f"dryrun subprocess: {len(cells)} cells in {secs!r} s")
    out.unlink(missing_ok=True)
    return secs


def fabric_zero1(dev, per_run):
    """ZeRO-1, the fault runtime, the sharded checkpoint, the recovery loop
    and the wave timer on the world-1 NCCL group already initialised, at
    full width and ``ZERO1_LAYERS`` deep, each held to ``phase_zero1``'s
    stacked run (``ZERO1_REF``)
    bit for bit; every run counted into ``per_run``."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.data import SyntheticLMStream
    from repro_torch.dist.fabric import ProcessGroupFabric
    from repro_torch.dist.steps import (fault_runtime_for_mesh,
                                        make_train_step)
    from repro_torch.launch import train
    from repro_torch.models.api import build
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.optim.sharded import ShardedOptState
    from repro_torch.telemetry.timing import timed_waves
    group = dist.group.WORLD
    cfg = zero1_cfg()
    api = build(cfg)
    stream = SyntheticLMStream(cfg.vocab, 256, 32, seed=0)

    def batch(step):
        return {"tokens": torch.as_tensor(stream.batch(step),
                                          dtype=torch.long, device=dev)}

    def run(tag, extra, keep=False):
        torchrun_env(0, 1)
        try:
            reset_all()
            t0 = time.perf_counter()
            res = train.main(FABRIC_ZERO1 + extra, keep_first_step=keep,
                             cfg=cfg)
            torch.cuda.synchronize()
            per_run[tag] = counts()
        finally:
            for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
                os.environ.pop(key)
        log(f"{tag}: losses {res.losses}, grad norms {res.grad_norms}, "
            f"s/step {res.step_seconds}, {time.perf_counter() - t0!r} s in "
            f"all, launches {per_run[tag]}")
        return res

    def same(res, ref, what=("params", "mu", "nu")):
        got = {"params": lambda: flat_of(res.params).cpu(),
               "mu": lambda: res.opt_state.mu.cpu(),
               "nu": lambda: res.opt_state.nu.cpu()}
        return res.losses == ref["losses"] and \
            res.grad_norms == ref["grad_norms"] and \
            all(torch.equal(got[k](), ref[k]) for k in what)

    # 1. --zero1, 3 steps, and its peak over what it found allocated
    ref = ZERO1_REF["run1"]
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = run("fabric nccl-1 zero1 torus4x4", ["--zero1", "--steps", "3"],
              keep=True)
    peak = torch.cuda.max_memory_allocated() - base_mem
    equal = same(res, ref)
    log(f"fabric nccl-1 zero1: losses, grad norms, parameters, mu and nu "
        f"equal to phase_zero1's stacked run 1 {equal}; moments "
        f"{tuple(res.opt_state.mu.shape)} on the rank; peak over the "
        f"run's start {peak / 1e9:.4f} GB (stacked {ref['peak'] / 1e9:.4f}"
        f" GB)")
    assert equal, "world-1 zero1 differs from the stacked run"
    assert peak <= ref["peak"] + FABRIC_PEAK_SLACK, (peak, ref["peak"])
    assert per_run["fabric nccl-1 zero1 torus4x4"]["tree_combine"] > 0
    del res
    torch.cuda.empty_cache()

    # 2. --zero1 --quantize-grads, 2 steps
    tag = "fabric nccl-1 zero1+q8 torus4x4"
    res = run(tag, ["--zero1", "--quantize-grads", "--steps", "2"])
    equal = same(res, ZERO1_REF["run2"])
    log(f"fabric nccl-1 zero1+q8: equal to the stacked run 2 {equal}")
    assert equal, "world-1 zero1+q8 differs from the stacked run"
    c = per_run[tag]
    assert c["q8_pack_rows"] > 0 and c["q8_unpack_rows"] > 0, c
    del res
    torch.cuda.empty_cache()

    # 3. the striped fault runtime from Python: the first flip of run 3
    ref = ZERO1_REF["run3"]
    rt = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES, engine="striped")
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    zstep = make_train_step(api, opt, TORUS_MESH, MESH_NAMES, zero1=True,
                            fault_runtime=rt, telemetry=True, group=group)
    fabric = ProcessGroupFabric(N_VERT, dev)
    sid = ref["sid"]
    params = to_dev(ref["params"], dev)
    n_p = n_params(params)
    mu0, nu0 = ref["mu"].to(dev), ref["nu"].to(dev)
    t0 = time.perf_counter()
    mu = rt.reshard_owned(mu0, 0, sid, n_p, fabric)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    back = rt.reshard_owned(mu, sid, 0, n_p, fabric)
    there_back = torch.equal(back, mu0)
    del back, mu0
    t0 = time.perf_counter()
    nu = rt.reshard_owned(nu0, 0, sid, n_p, fabric)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    del nu0
    tag = "fabric nccl-1 zero1 fault runtime step"
    reset_all()
    new_params, new_state, met = zstep(
        params, ShardedOptState(ref["opt_step"], mu, nu), batch(ref["step"]),
        sid)
    torch.cuda.synchronize()
    per_run[tag] = counts()
    out = ref["out"]
    equal = float(met["loss"]) == out["loss"] and \
        float(met["grad_norm"]) == out["grad_norm"] and \
        torch.equal(flat_of(new_params).cpu(), out["params"]) and \
        torch.equal(new_state.mu.cpu(), out["mu"]) and \
        torch.equal(new_state.nu.cpu(), out["nu"])
    log(f"fabric nccl-1 flip 0 -> {sid} ({rt.entries[sid].name}): "
        f"reshard_owned over the group {t_first!r} s (first call, the plan "
        f"built), {t_warm!r} s (nu); there and back equal {there_back}; the "
        f"step on it equal to the stacked run 3's step {ref['step'] + 1} "
        f"{equal}, replicas equal {met['ag_replicas_equal']}, launches "
        f"{per_run[tag]}")
    assert there_back and equal and met["ag_replicas_equal"], tag
    del params, mu, nu, new_params, new_state, met
    torch.cuda.empty_cache()

    # 4. --zero1 --ckpt-dir: 2 steps, resumed to 3; the files of step 2
    # (saved once, at step 2: the stacked run saved every step)
    ck = ROOT / "build" / "ckpt_fabric"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        run("fabric nccl-1 zero1 torus4x4 ckpt",
            ["--zero1", "--steps", "2", "--ckpt-dir", str(ck),
             "--ckpt-every", "2"])
        res = run("fabric nccl-1 zero1 torus4x4 resumed",
                  ["--zero1", "--steps", "3", "--ckpt-dir", str(ck)])
        ref = ZERO1_REF["run1"]
        equal = res.start_step == 2 and res.losses == ref["losses"][2:] and \
            torch.equal(flat_of(res.params).cpu(), ref["params"]) and \
            torch.equal(res.opt_state.mu.cpu(), ref["mu"]) and \
            torch.equal(res.opt_state.nu.cpu(), ref["nu"])
        del res
        files, names = same_ckpt_files(ck / "step_00000002",
                                       ZERO1_REF["ckpt"] / "step_00000002")
        log(f"fabric nccl-1 zero1 resumed at step 2 to 3: equal to the "
            f"uninterrupted stacked run {equal}; step 2's {len(names)} files "
            f"equal to the stacked run 4's, array for array {files}")
        assert equal and files, "world-1 checkpoint differs"
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(ZERO1_REF.pop("ckpt"), ignore_errors=True)
    torch.cuda.empty_cache()

    # 5. --recover, then a masked link until the flip, and a step on it
    ref = ZERO1_REF["run5"]
    rec = run("fabric nccl-1 edst torus4x4 recover",
              ["--sync", "edst", "--recover", "--steps", "2"])
    equal = same(rec, ref, ("params",))
    ctrl, mon = rec.controller, rec.monitor
    s_, d_ = sorted(ctrl.runtime.entries[0].sched.trees[0].tree)[0]
    mask = [0.0 if link == (s_, d_) else 1.0 for link in mon.links]
    for tick in range(2, 6):
        dec = ctrl.observe(mon.check(tick, fault_mask=mask))
        if dec.action == "flip":
            break
    rows = [{k: v for k, v in r.items() if k != "mttr_s"}
            for r in ctrl.journal_rows()]
    same_journal = tick == ref["flip_tick"] and rows == [
        {k: v for k, v in r.items() if k != "mttr_s"}
        for r in ref["journal"]]
    opt2 = AdamW(cosine_schedule(3e-4, 20, 2))
    step_fn = make_train_step(api, opt2, TORUS_MESH, MESH_NAMES, mode="edst",
                              fault_runtime=ctrl.runtime, telemetry=True,
                              group=group)
    tag = "fabric nccl-1 edst torus4x4 recover flipped"
    reset_all()
    new_params, _, met = step_fn(rec.params, rec.opt_state, batch(2),
                                 ctrl.schedule_id)
    torch.cuda.synchronize()
    per_run[tag] = counts()
    flipped = ref["flipped"]
    step_equal = float(met["loss"]) == flipped["loss"] and \
        float(met["grad_norm"]) == flipped["grad_norm"] and \
        torch.equal(flat_of(new_params).cpu(), flipped["params"])
    log(f"fabric nccl-1 recover: 2 steps equal to the stacked run 5 "
        f"{equal}; the masked link {(s_, d_)} flipped at tick {tick} to "
        f"{ctrl.runtime.entry.name}, journal as stacked {same_journal}; the "
        f"step on it equal to the stacked one {step_equal}, sync_dev "
        f"{met['sync_dev']!r}, launches {per_run[tag]}")
    assert equal and same_journal and step_equal, "world-1 recover differs"
    assert dec.action == "flip" and met["sync_dev"] == 0.0
    _held_to_psum(f"fabric nccl-1 recover step 3 ({ctrl.runtime.entry.name})",
                  rec.params, rec.opt_state, batch(2), new_params,
                  met["grad_norm"], opt2, cfg=cfg)
    del rec, new_params, ctrl, mon, step_fn
    torch.cuda.empty_cache()

    # 6. the wave timer: the torus's pipelined program at the full gradient
    spec = engine_specs((4, 4))["pipelined"]
    reset_all()
    got = timed_waves(spec, 4 * N_PARAMS, FABRIC_WAVE_ITERS, device=dev,
                      group=group)
    per_run["fabric nccl-1 timed_waves"] = counts()
    want = timed_waves(spec, 4 * N_PARAMS, FABRIC_WAVE_ITERS, device=dev)
    torch.cuda.empty_cache()
    pairs = [(a * 1e3, b * 1e3) for a, b in zip(got[0], want[0])]
    log(f"fabric nccl-1 timed_waves torus4x4 pipelined {4 * N_PARAMS} B: "
        f"{len(got[0])} waves over the group, {len(want[0])} stacked; "
        f"device ms (group, stacked): {pairs}; totals {sum(got[0])!r} s, {sum(want[0])!r} s; launches "
        f"{per_run['fabric nccl-1 timed_waves']}")
    assert len(got[0]) == len(want[0]) == len(spec.waves)
    assert all(t > 0 for t in got[0])


def phase_fabric(dev):
    """The process-group fabric on the card: a world-1 NCCL group (rank 0
    of 1, a ``FileStore`` in a temporary directory) carries the full-width
    4x4 torus allreduce (pipelined S=1 and striped, f32 and int8), each
    result equal bit for bit to the stacked fabric's (``phase_allreduce``'s
    input and engines), both timed; ``launch/train.py``'s ``main`` at world
    size 1 on NCCL with ``phase_train``'s arguments (edst, 2 steps;
    psum_dp, 1 step), its losses and parameters equal bit for bit to a
    stacked run's and its peak memory within ``FABRIC_PEAK_SLACK`` of it;
    and
    ``pipeline_apply`` of smollm-135m's layer body (6 stages of 5 layers,
    8 microbatches of 4 x 256, f32) on both fabrics, equal bit for bit to
    the 30 layers in order.  The edst run's warm step is timed in the
    order stacked, NCCL, NCCL, stacked.  On the same group, at full width
    (``fabric_zero1``): ``--zero1`` 3 steps and ``--zero1
    --quantize-grads`` 2, the striped fault runtime's first flip of
    ``phase_zero1``'s run 3 (``reshard_owned`` over the group there and
    back, and the step on the degraded class), ``--zero1 --ckpt-dir`` 2
    steps resumed to 3 (its files equal the stacked run's), ``--recover``
    2 steps, a masked probe until the flip and a step on it, each bit for
    bit with ``phase_zero1``'s stacked run (``ZERO1_REF``), the zero1
    peak within ``FABRIC_PEAK_SLACK`` of the stacked one's; and
    ``timed_waves`` of the pipelined program at the full gradient over the
    group beside the stacked fabric.  Then 4 gloo ranks on the host train
    the reduced smollm-135m 2 edst steps and 2 zero1 steps on the torus,
    equal bit for bit to stacked host runs, and a probe masked on one rank
    flips every rank alike; with two or more cards, min(count, 4) NCCL
    ranks run the full-width allreduce against the stacked engine and one
    zero1 step against ``phase_zero1``'s.  Returns ``{run: {kernel:
    launches}}``."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
    from repro_torch.dist.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    per_run = {}
    specs = engine_specs((4, 4))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1,
            device_id=dev)
        try:
            g = torch.Generator(device=dev).manual_seed(1)
            x = torch.randn((N_VERT, N_PARAMS), generator=g, device=dev)
            stacked = StackedFabric(N_VERT, dev)
            pg = ProcessGroupFabric(N_VERT, dev)
            assert pg.world == 1 and pg.rows == N_VERT, (pg.world, pg.rows)
            log(f"fabric: a world-1 {pg.backend} group on {dev}")
            for engine, codec in FABRIC_CELLS:
                spec = specs[engine]
                want = run_engine(engine, x, spec, stacked, codec)
                torch.cuda.synchronize()
                reset_all()
                got = run_engine(engine, x, spec, pg, codec)
                torch.cuda.synchronize()
                tag = f"fabric nccl-1 {engine} torus4x4 {codec}"
                per_run[tag] = c = counts()
                equal = torch.equal(got, want)
                del got, want
                ms_stacked = timed(lambda: run_engine(engine, x, spec,
                                                      stacked, codec))
                ms_pg = timed(lambda: run_engine(engine, x, spec, pg, codec))
                log(f"{tag}: equal to the stacked fabric {equal}; stacked "
                    f"{ms_stacked / 1e3!r} s, world-1 NCCL {ms_pg / 1e3!r} s "
                    f"({ms_pg / ms_stacked:.4f}x), launches {c}")
                assert equal, tag
                assert c["tree_combine"] > 0, (tag, c)
                torch.cuda.empty_cache()
            del x
            torch.cuda.empty_cache()

            # the group's first collective (the cells above issued none)
            # and a second, timed: what the first NCCL train step pays
            one, coll_s = torch.zeros(1, device=dev), []
            for _ in range(2):
                t0 = time.perf_counter()
                dist.all_reduce(one)
                torch.cuda.synchronize()
                coll_s.append(time.perf_counter() - t0)
            log(f"fabric nccl-1 group: first all_reduce {coll_s[0]!r} s, "
                f"second {coll_s[1]!r} s")

            # launch/train.py at world size 1 on NCCL against the stacked
            # run, each with its peak memory
            for sync, steps in FABRIC_SYNCS:
                argv = FABRIC_TRAIN + ["--sync", sync, "--steps", steps,
                                       "--device", dev.type]
                assert "WORLD_SIZE" not in os.environ
                torch.cuda.reset_peak_memory_stats()
                ref = train.main(argv, cfg=train_cfg())
                ref_peak = torch.cuda.max_memory_allocated()
                # the stacked parameters wait on the host, out of the
                # world-1 run's peak
                ref_losses, ref_params = ref.losses, flat_of(ref.params).cpu()
                ref_secs = ref.step_seconds
                del ref
                torch.cuda.empty_cache()
                torchrun_env(0, 1)
                try:
                    reset_all()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    res = train.main(argv, cfg=train_cfg())
                    torch.cuda.synchronize()
                    t_res = time.perf_counter() - t0
                    peak = torch.cuda.max_memory_allocated()
                    tag = f"fabric nccl-1 train {sync} torus4x4"
                    per_run[tag] = c = counts()
                finally:
                    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
                        os.environ.pop(key)
                if sync == "edst":   # ABBA: stacked, NCCL, NCCL, stacked
                    abba = {"stacked": [ref_secs[1]],
                            "nccl-1": [res.step_seconds[1]]}
                equal = res.losses == ref_losses and torch.equal(
                    flat_of(res.params).cpu(), ref_params)
                log(f"{tag}: losses {res.losses} (stacked {ref_losses}), "
                    f"parameters and losses equal {equal}; s/step "
                    f"{res.step_seconds} (stacked, just before: {ref_secs}), "
                    f"{t_res!r} s in all, peak memory {peak / 1e9:.4f} GB "
                    f"(stacked {ref_peak / 1e9:.4f} GB), launches {c}")
                assert equal, f"{tag} differs from the stacked run"
                assert peak <= ref_peak + FABRIC_PEAK_SLACK, (tag, peak,
                                                              ref_peak)
                if sync == "edst":
                    assert c["tree_combine"] > 0, c
                del res, ref_params
                torch.cuda.empty_cache()
                if sync == "edst":
                    abba_turns(argv, abba)

            # gspmd with DTensor parameters on the group's (1, 1) mesh
            t0 = time.perf_counter()
            fabric_gspmd(dev, per_run)
            log(f"fabric nccl-1 gspmd: {time.perf_counter() - t0!r} s")

            # ZeRO-1, the fault runtime, checkpoints, the recovery loop and
            # the wave timer over the group, held to phase_zero1's runs
            t0 = time.perf_counter()
            fabric_zero1(dev, per_run)
            log(f"fabric nccl-1 zero1/fault/ckpt/recover/timer: "
                f"{time.perf_counter() - t0!r} s")

            # GPipe over smollm-135m's layers on both fabrics
            with torch.no_grad():
                stage_fn, stage_params, xm, sequential = pipeline_stages(dev)
                want = sequential(xm)
                runs = {"sequential": lambda: sequential(xm)}
                outs = {}
                for name, fab in (("stacked", StackedFabric(PIPE_STAGES,
                                                            dev)),
                                  ("nccl-1", ProcessGroupFabric(PIPE_STAGES,
                                                                dev))):
                    outs[name] = pipeline_apply(stage_fn, stage_params, xm,
                                                fab)
                    runs[name] = functools.partial(
                        pipeline_apply, stage_fn, stage_params, xm, fab)
                # each timed after a warm-up call, the fabrics in the
                # order stacked, NCCL, NCCL, stacked, so that neither pays
                # the first call's setup or a drift of the host's speed
                secs = {}
                for name in PIPE_TIMED:
                    secs.setdefault(name, []).append(
                        timed(runs[name], rounds=3) / 1e3)
            equal = {name: torch.equal(outs[name], want)
                     for name in ("stacked", "nccl-1")}
            log(f"fabric pipeline smollm-135m ({PIPE_STAGES} stages of "
                f"5 layers, {PIPE_MICRO} x {PIPE_MB} x {PIPE_SEQ}, f32): "
                f"equal to the 30 layers in order {equal}, finite "
                f"{bool(torch.isfinite(want).all())}; warm s (each the "
                f"median of 3, in the order {PIPE_TIMED}): sequential "
                f"{secs['sequential']}, stacked {secs['stacked']}, world-1 "
                f"NCCL {secs['nccl-1']} (bubble {bubble_fraction(PIPE_MICRO, PIPE_STAGES):.4f})")
            assert all(equal.values()), equal
            assert torch.isfinite(want).all()
            del outs, runs, want, xm, stage_params
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

    # gloo ranks on the host: the multi-rank exchange, on this machine's
    # torch, against a stacked host run (one thread, as each rank runs)
    t0 = time.perf_counter()
    got = spawn_ranks(gloo_train_rank, GLOO_RANKS, ())
    t_gloo = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = train.main(GLOO_TRAIN)
        zref = train.main(GLOO_ZERO1)
        probe = masked_probe_flip()
    finally:
        torch.set_num_threads(threads)
    ref_params = flat_of(ref.params)
    equal = [r["losses"] == ref.losses and torch.equal(r["params"],
                                                         ref_params)
             for r in got]
    log(f"fabric gloo CPU check ({GLOO_RANKS} ranks on the host, reduced "
        f"smollm-135m, edst, 4x4 torus, 4 vertices a rank, 2 steps): "
        f"losses {got[0]['losses']} (stacked {ref.losses}), every rank "
        f"equal to the stacked host run {equal}, {t_gloo!r} s in all")
    assert all(equal), equal
    zparams = flat_of(zref.params)
    zequal = [r["zero1"]["losses"] == zref.losses
              and torch.equal(r["zero1"]["params"], zparams)
              and torch.equal(r["zero1"]["mu"], zref.opt_state.mu[4 * i:
                                                                4 * i + 4])
              and torch.equal(r["zero1"]["nu"], zref.opt_state.nu[4 * i:
                                                                4 * i + 4])
              for i, r in enumerate(got)]
    log(f"fabric gloo zero1 (2 steps, each rank its 4 vertices' moments): "
        f"losses {got[0]['zero1']['losses']} (stacked {zref.losses}), every "
        f"rank equal to the stacked host run {zequal}")
    assert all(zequal), zequal

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "mttr_s"} for r in rows]
    flips = [r["probe"] for r in got]
    alike = all(f == flips[0] for f in flips) and \
        flips[0][:2] == probe[:2] and strip(flips[0][2]) == strip(probe[2])
    log(f"fabric gloo probe: a link of tree 0 masked on its receiving rank "
        f"only; every rank flips at tick {[f[0] for f in flips]} to schedule "
        f"{[f[1] for f in flips]}, journals identical and as stacked "
        f"(tick {probe[0]}, schedule {probe[1]}): {alike}")
    assert alike and probe[1] != 0, (flips, probe)

    cards = torch.cuda.device_count()
    if cards >= 2:
        world = min(cards, 4)
        got = spawn_ranks(allreduce_rank, world, (N_PARAMS,))
        log(f"fabric nccl-{world}: full-width pipelined torus4x4 f32 over "
            f"{world} cards, rows {[r['rows'] for r in got]}, equal to the "
            f"stacked engine {[r['equal'] for r in got]}, s "
            f"{[r['seconds'] for r in got]}")
        assert all(r["equal"] for r in got)
        got = spawn_ranks(zero1_rank, world, ())
        ref = ZERO1_REF["run1"]
        equal = [r["losses"] == ref["losses"][:1]
                 and r["grad_norms"] == ref["grad_norms"][:1]
                 and torch.equal(r["params"], ref["first"]) for r in got]
        log(f"fabric nccl-{world}: zero1 1 step at full width over {world} "
            f"cards, moment rows {[r['rows'] for r in got]}, equal to the "
            f"stacked run 1's first step {equal}")
        assert all(equal)
    else:
        log(f"fabric multi-rank NCCL (the allreduce and a zero1 step): not "
            f"run: {cards} CUDA device here, and NCCL refuses two ranks of "
            "one communicator on one GPU (\"Duplicate GPU detected\"), so "
            "the multi-rank exchange is held over gloo on the host above")
    log(f"fabric phase: {time.perf_counter() - t_phase!r} s")
    return per_run


# The token families trained through launch/train.py at full width, depth
# cut so that the stacked fabric's (n, P) gradient rows, their waves and
# AdamW fit the card: (arch, layers, --mesh).  recurrentgemma-2b keeps one
# whole (rec, rec, attn) pattern on the 2-vertex fabric (even 1 layer on the
# 2x2 torus would need about 73 GB); the others take the 2x2 torus (k = 1).
FAMILY_TRAIN = (("rwkv6-7b", 1, "2,2,1"), ("olmoe-1b-7b", 1, "2,2,1"),
                ("recurrentgemma-2b", 3, "2,1"))
# (attention layers at FAMILY_TRAIN's depth, whether they train on the flash
# kernels): recurrentgemma-2b's head dim 256 has no backward instance
FAMILY_ATTN = {"rwkv6-7b": (0, True), "olmoe-1b-7b": (1, True),
               "recurrentgemma-2b": (1, False)}
# gspmd's one whole-batch pass rounds its bf16 activations and bf16 weight
# gradients at other shapes than psum_dp's per-vertex passes: its grad norm
# is held to one bf16 unit roundoff, and its move (Adam's first step, about
# lr * sign(g), where a sign of a gradient within rounding of zero may flip)
# to 0.1, far below the sqrt(2) of an unrelated step
GSPMD_GN_REL, GSPMD_MOVE_REL = 2.0 ** -8, 0.1
# phase_train_families' stacked gspmd run of each family, on the host, for
# fabric_gspmd's DTensor runs of the same seed and depth: arch -> losses,
# grad norms, step seconds, the initial parameters and the first move
# (flat, f32) and the run's peak bytes
FAMILY_GSPMD_REF = {}


def phase_train_families(dev):
    """rwkv6-7b, olmoe-1b-7b and recurrentgemma-2b (``FAMILY_TRAIN``) at
    full width through the training entry point (``train.main(argv,
    cfg=...)``), f32 params, bf16 activations, remat on, batch 8 x 256:
    ``--sync psum_dp`` for one step; ``--sync edst`` (pipelined) for two,
    the first held to psum_dp's (move within 1e-5 of its size, grad norm
    within 1e-6); ``--sync gspmd`` for two, the first held to psum_dp's
    within ``GSPMD_MOVE_REL`` and ``GSPMD_GN_REL``; for rwkv6-7b also
    ``--sync edst --quantize-grads`` for two; one more edst run of two
    steps under the profiler, whose second step ``trace_split`` splits.
    Losses finite, the MoE's
    aux metrics finite, ``tree_combine`` launched in every f32 edst run
    and the int8 codec (pack, combine, unpack) in the int8 one; each
    run's attention counters as :func:`attention_counts` gives them for
    ``FAMILY_ATTN``, and in gspmd's every other counter 0; peak under 60
    GB.  Each
    gspmd run's losses, grad norms, step seconds, first step, peak and
    launches stay on the host in
    ``FAMILY_GSPMD_REF`` for ``fabric_gspmd``.
    Every launch counter is set to 0 just before each run and read just
    after it; returns ``{run: {kernel: launches}}``."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.dist.steps import edst_spec_for_mesh
    from repro_torch.launch import train
    per_run = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}
    for arch, layers, mesh in FAMILY_TRAIN:
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        assert cfg.remat and cfg.act_dtype == torch.bfloat16, arch
        base = ["--arch", arch, "--batch", "8", "--seq", "256", "--mesh",
                mesh, "--log-every", "1", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()

        def run(tag, extra, cfg=cfg, base=base, keep=True, arch=arch):
            reset_all()
            t0 = time.perf_counter()
            peaks[arch] = max(peaks.get(arch, 0),
                              torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            res = train.main(base + extra, keep_first_step=keep, cfg=cfg)
            torch.cuda.synchronize()
            res.peak = torch.cuda.max_memory_allocated()
            per_run[tag] = c = counts()
            held_attention(tag, c, base + extra, *FAMILY_ATTN[arch],
                           only="gspmd" in extra)
            aux = {k: float(v) for k, v in res.metrics.items()
                   if k.startswith("moe_")}
            assert all(math.isfinite(v) for v in res.losses), (tag,
                                                               res.losses)
            assert all(math.isfinite(v) for v in aux.values()), (tag, aux)
            if cfg.is_moe:
                assert set(aux) == {"moe_load_balance", "moe_router_z"}, aux
            log(f"train {tag}: losses {res.losses}, grad norms "
                f"{res.grad_norms}, s/step {res.step_seconds}, "
                f"{time.perf_counter() - t0!r}s in all, aux {aux}, "
                f"launches {c}")
            return res

        def first_step(res):
            """(init, move) of a run's first step, flat, on the host."""
            p0 = flat_of(res.init_params)
            d = flat_of(res.first_step_params) - p0
            return p0.cpu(), d.cpu()

        psum = run(f"{arch} psum_dp", ["--sync", "psum_dp", "--steps", "1"])
        p0, d_psum = first_step(psum)
        gn_psum = psum.grad_norms[0]
        del psum
        runs = [("edst", ["--sync", "edst", "--steps", "2"], 1e-5, 1e-6),
                ("gspmd", ["--sync", "gspmd", "--steps", "2"],
                 GSPMD_MOVE_REL, GSPMD_GN_REL)]
        if arch == "rwkv6-7b":
            runs.append(("edst+q8", ["--sync", "edst", "--quantize-grads",
                                     "--steps", "2"], None, None))
        for sync, extra, lim_move, lim_gn in runs:
            tag = f"{arch} {sync}"
            res = run(tag, extra)
            c = per_run[tag]
            if sync == "gspmd":
                # and no other kernel but the attention's (held_attention)
                assert sync_launches(c) == 0, (tag, c)
            elif sync == "edst":
                assert c["tree_combine"] > 0, (tag, c)
            else:
                # k = 1: every int8 reduce hop lands through q8_combine
                assert min(c[k] for k in ("q8_pack_rows", "q8_combine_rows",
                                          "q8_unpack_rows")) > 0, (tag, c)
                del res
                continue
            q0, d = first_step(res)
            gn = res.grad_norms[0]
            if sync == "edst":
                warm = res.step_seconds[1]
            else:
                FAMILY_GSPMD_REF[arch] = {
                    "losses": res.losses, "grad_norms": res.grad_norms,
                    "step_seconds": res.step_seconds, "p0": q0, "d": d,
                    "peak": res.peak, "launches": c}
            del res
            assert torch.equal(q0, p0), f"{tag}: a different init"
            del q0
            d, ref = d.to(dev), d_psum.to(dev)
            rel = float((d - ref).norm() / ref.norm())
            gap = float((d - ref).abs().max())
            del d, ref
            gn_rel = abs(gn - gn_psum) / gn_psum
            log(f"{tag} vs psum_dp, step 1: |d - d_psum| / |d_psum| "
                f"{rel!r} (<= {lim_move}), max {gap!r}; grad norm {gn!r} "
                f"vs {gn_psum!r}, relative {gn_rel!r} (<= {lim_gn})")
            assert rel <= lim_move, (tag, rel)
            assert gn_rel <= lim_gn, (tag, gn_rel)
        del p0, d_psum
        # the split of one profiled edst step (the second of two)
        prof_dir = ROOT / "build" / "profile_families"
        shutil.rmtree(prof_dir, ignore_errors=True)
        res = run(f"{arch} edst profiled", ["--sync", "edst", "--steps", "2",
                                            "--profile-dir", str(prof_dir)],
                  keep=False)
        dims, names = train.parse_mesh(mesh)
        split = trace_split(res.profile_trace,
                            len(edst_spec_for_mesh(dims, names).waves))
        del res
        shutil.rmtree(prof_dir, ignore_errors=True)
        busy, in_waves = (split[k] / 1e3 for k in ("device_busy_ms",
                                                   "device_busy_in_waves_ms"))
        log(f"profiled edst step ({arch}, step 2 of 2): {split}; device "
            f"busy {busy / warm:.1%} of the unprofiled warm step ({warm!r} "
            f"s), in the waves {in_waves / warm:.1%}")
        assert split["device_events"] > 0 and in_waves > 0, (arch, split)
        peaks[arch] = max(peaks[arch], torch.cuda.max_memory_allocated())
        log(f"train {arch} ({layers} of {configs.get(arch).n_layers} "
            f"layers, --mesh {mesh}) peak memory: {peaks[arch] / 1e9:.2f} GB")
    peak = max(peaks.values())
    log(f"train families peak memory: {peak / 1e9:.2f} GB")
    assert peak < 60e9, peaks
    return per_run


def fault_loop_cfg():
    """smollm-135m as ``phase_zero1``, ``phase_elastic`` and
    ``phase_telemetry`` train it: remat off.  Remat recomputes the same
    forward in the backward and changes no value, but on this host-bound
    per-vertex loop it adds about half to a step (the striped engine's
    warm step, one run on an H100: 5.49 s in ``phase_train`` with it,
    3.58-3.91 s in ``phase_zero1`` without), and those phases run about
    40 steps; ``phase_train`` trains with it on."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get("smollm-135m"), remat=False)


# phase_elastic's depth: smollm-135m at full width, 15 of its 30 layers.
# At all 30 the smoke read 1160.7 s against the 1200 s limit (PERF.md,
# PR 26); every check of the phase is kept
ELASTIC_LAYERS = 15


def elastic_cfg():
    """``fault_loop_cfg`` cut to ``ELASTIC_LAYERS`` layers."""
    import dataclasses
    return dataclasses.replace(fault_loop_cfg(), n_layers=ELASTIC_LAYERS)


# phase_zero1's and fabric_zero1's depth: smollm-135m at full width, 10 of
# its 30 layers (the fabric's runs are held to phase_zero1's, so both).  At
# all 30 the smoke passed 1300 s once the blockwise attention's
# checkpointed step was in the training paths (PERF.md); every check of
# the two phases is kept, and the synthetic allreduce payloads stay at the
# full (16, 134,515,008)
ZERO1_LAYERS = 10


def zero1_cfg():
    """``fault_loop_cfg`` cut to ``ZERO1_LAYERS`` layers."""
    import dataclasses
    return dataclasses.replace(fault_loop_cfg(), n_layers=ZERO1_LAYERS)


def n_params(tree):
    """The number of parameters of a tree of tensors (the flat width)."""
    from repro_torch.optim.adamw import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


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
        flat = torch.zeros((n_params(params),), dtype=torch.float32,
                           device=m.device)
        flat[idx] = m[live]
        out.append(_unflatten(flat, params))
    return OptState(step, out[0], out[1])


def _held_to_psum(tag, params, dense_state, batch, new_params, grad_norm,
                  opt, mesh=TORUS_MESH, cfg=None):
    """Hold one step (``params`` -> ``new_params``, its pre-clip grad norm
    ``grad_norm``) to a psum_dp step on ``mesh`` from the same params and
    optimizer state: the move within 1e-5 of psum_dp's relative to its
    size, the grad norm within 1e-5 (both are sums over the vertices in
    another order).  ``cfg`` is the model's (``fault_loop_cfg()`` when
    None).  Returns (move, grad norm) relative differences."""
    import torch
    from repro_torch.dist.steps import make_train_step
    from repro_torch.models.api import build
    step = make_train_step(build(cfg or fault_loop_cfg()), opt, mesh,
                           MESH_NAMES, mode="psum_dp")
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


# phase_zero1's stacked results on the host, the references phase_fabric
# holds its world-1 NCCL runs to (so that no stacked run is repeated)
ZERO1_REF: dict = {}


def to_host(tree):
    """A tree of tensors copied to the host (a dense OptState's trees too)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_zero1(dev):
    """ZeRO-1, the fault runtime, checkpoints and the recovery loop at full
    width, ``ZERO1_LAYERS`` deep, on the 4x4 torus.  Every counted run is set to 0 just before it
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
    from repro_torch.models.api import build
    from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
    base = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
            "--log-every", "1", "--device", "cuda", "--mesh", "4,4,1"]
    cfg = zero1_cfg()
    api = build(cfg)
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
        res = train.main(base + extra, keep_first_step=keep, cfg=cfg)
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
        step = make_train_step(api, AdamW(cosine_schedule(3e-4, 20, 100)),
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
    # run 1's own peak over what it found allocated (phase_fabric's world-1
    # run is held to it); the phase's peak so far is kept aside
    phase_peak = torch.cuda.max_memory_allocated()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    z1 = run("zero1 torus4x4", ["--zero1", "--steps", "3"], keep=True)
    ZERO1_REF["run1"] = {
        "losses": z1.losses, "grad_norms": z1.grad_norms,
        "peak": torch.cuda.max_memory_allocated() - base_mem,
        "params": flat_of(z1.params).cpu(),
        "first": flat_of(z1.first_step_params).cpu(),
        "mu": z1.opt_state.mu.cpu(), "nu": z1.opt_state.nu.cpu()}
    after = run("edst striped torus4x4 (after zero1)", striped)
    warm = {"striped before": before.step_seconds[1:],
            "zero1": z1.step_seconds[1:],
            "striped after": after.step_seconds[1:]}
    del before, after
    rows_identical("zero1 torus4x4 rows check", z1)
    assert per_run["zero1 torus4x4"]["tree_combine"] > 0
    opt3 = AdamW(cosine_schedule(3e-4, 20, 3))
    _held_to_psum("zero1 step 1", z1.init_params, opt3.init(z1.init_params),
                  batch(0), z1.first_step_params, z1.grad_norms[0], opt3,
                  cfg=cfg)
    del z1.init_params, z1.first_step_params
    log(f"zero1: allgathered params identical on all {N_VERT} vertex rows "
        f"(bit for bit); warm s/step in turns: {warm}")

    # 2. the int8 gradient wire
    q = run("zero1+q8 torus4x4", ["--zero1", "--quantize-grads",
                                  "--steps", "2"])
    ZERO1_REF["run2"] = {"losses": q.losses, "grad_norms": q.grad_norms,
                         "params": flat_of(q.params).cpu(),
                         "mu": q.opt_state.mu.cpu(),
                         "nu": q.opt_state.nu.cpu()}
    c = per_run["zero1+q8 torus4x4"]
    assert c["q8_pack_rows"] > 0 and c["q8_unpack_rows"] > 0, c
    rows_identical("zero1+q8 torus4x4 rows check", q, quantize=True)
    del q

    # 3. a link kill through the fault runtime, driven from Python
    rt = fault_runtime_for_mesh(TORUS_MESH, MESH_NAMES, engine="striped")
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    zstep = make_train_step(api, opt, TORUS_MESH, MESH_NAMES, zero1=True,
                            fault_runtime=rt, telemetry=True)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    n_p = n_params(params)
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
                if "run3" not in ZERO1_REF:     # the first flip's input
                    ZERO1_REF["run3"] = {
                        "step": i, "sid": sid, "params": to_host(params),
                        "opt_step": state.step, "mu": state.mu.cpu(),
                        "nu": state.nu.cpu()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mu = rt.reshard_owned(state.mu, frm, sid, n_p)
                torch.cuda.synchronize()
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
                nu = rt.reshard_owned(state.nu, frm, sid, n_p)
                torch.cuda.synchronize()
                t_warm = time.perf_counter() - t0
                back = rt.reshard_owned(mu, sid, frm, n_p)
                assert torch.equal(back, state.mu), "reshard is not exact"
                del back
                log(f"zero1 flip {frm} -> {sid} ({rt.entries[sid].name}): "
                    f"reshard_owned of mu {t_first!r}s (first call), of "
                    f"nu {t_warm!r}s; there and back equals mu bit for bit")
                state = type(state)(state.step, mu, nu)
                del mu, nu
            dense = _dense_state(state.step, state.mu, state.nu,
                                 rt.zero1_element_map(n_p, sid), params)
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
                          batch(i), new_params, met["grad_norm"], opt,
                          cfg=cfg)
            del dense
            ref3 = ZERO1_REF.get("run3")
            if ref3 is not None and ref3["step"] == i:
                ref3["out"] = {"loss": float(met["loss"]),
                               "grad_norm": float(met["grad_norm"]),
                               "params": flat_of(new_params).cpu(),
                               "mu": new_state.mu.cpu(),
                               "nu": new_state.nu.cpu()}
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

    # 4. checkpoints: 2 steps saved every step, resumed to 3 (the directory
    # stays for phase_fabric, which compares its own files with it)
    ck = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ck, ignore_errors=True)
    kept = False
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
        emap = owner_element_map(spec, n_p)
        timing = ROOT / "build" / "ckpt_timing"
        shutil.rmtree(timing, ignore_errors=True)
        t0 = time.perf_counter()
        save_sharded_checkpoint(str(timing), 3, z1.params, z1.opt_state,
                                emap, n_p)
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
                              rt.zero1_element_map(n_p, 0), step=2)[1]
        on1 = restore_sharded(str(ck), z1.params,
                              rt.zero1_element_map(n_p, 1), step=2)[1]
        moved = rt.reshard_owned(on0.mu, 0, 1, n_p)
        ok = torch.equal(on1.mu, moved) and torch.equal(
            on1.nu, rt.reshard_owned(on0.nu, 0, 1, n_p))
        log(f"checkpoint: sharded save {t_save!r}s, restore {t_restore!r}s "
            f"(params + moments, 16 shards, CRC32 checked); the step-2 "
            f"checkpoint restored onto {rt.entries[1].name}'s element map "
            f"equals reshard_owned of it restored onto entry 0's: {ok}")
        assert ok, "restore onto the degraded map differs from reshard"
        del on0, on1, moved
        ZERO1_REF["ckpt"] = ck
        kept = True
    finally:
        if not kept:
            shutil.rmtree(ck, ignore_errors=True)
    del z1
    torch.cuda.empty_cache()

    # 5. the recovery loop: --recover, then a masked link until the flip
    rec = run("edst torus4x4 recover", ["--sync", "edst", "--recover",
                                        "--steps", "2"], keep=True)
    ZERO1_REF["run5"] = {"losses": rec.losses, "grad_norms": rec.grad_norms,
                         "params": flat_of(rec.params).cpu()}
    opt2 = AdamW(cosine_schedule(3e-4, 20, 2))
    _held_to_psum("zero1 recover step 1 (dense edst on entry 0)",
                  rec.init_params, opt2.init(rec.init_params), batch(0),
                  rec.first_step_params, rec.grad_norms[0], opt2, cfg=cfg)
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
    ZERO1_REF["run5"]["journal"] = ctrl.journal_rows()
    ZERO1_REF["run5"]["flip_tick"] = tick
    step_fn = make_train_step(api, opt2, TORUS_MESH, MESH_NAMES,
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
                  met["grad_norm"], opt2, cfg=cfg)
    ZERO1_REF["run5"]["flipped"] = {"loss": float(met["loss"]),
                                    "grad_norm": float(met["grad_norm"]),
                                    "params": flat_of(new_params).cpu()}
    del rec, new_params
    torch.cuda.empty_cache()
    peak = max(phase_peak, torch.cuda.max_memory_allocated())
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
    """The fault loop closed at full width (smollm-135m at
    ``ELASTIC_LAYERS`` of its 30 layers, d 576): the static verifier on
    the path's specs, the chaos loop ending in a rescale, the elastic CLI,
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
    from repro_torch.analysis.verify import verify_spec
    from repro_torch.core.fault import FailureEvent
    from repro_torch.data import SyntheticLMStream
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.steps import fault_runtime_for_mesh
    from repro_torch.launch import elastic, train
    from repro_torch.optim import AdamW, cosine_schedule
    t_phase = time.perf_counter()
    cfg = elastic_cfg()
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
                             grad_norm, opt, mesh=mesh, cfg=cfg)

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
                 "--arch", "smollm-135m"], cfg=cfg)
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
                           keep_first_step=True, cfg=cfg)
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
                              mesh=RESUME_MESH, cfg=cfg)
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


SWEEP_SEGMENTS = (1, 2, 4, 8)
# phase_elastic's peak on an H100 when it trained the model at full depth
TELEMETRY_PEAK = 46.34e9


def best_of(fns, rounds):
    """Best host-clock seconds of one synchronised call per case, the
    cases interleaved round-robin so drift hits every case alike, after
    two untimed calls of each (the reference bench's ``_paired``)."""
    import torch
    for fn in fns.values():
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
    best = {name: math.inf for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[name] = min(best[name], time.perf_counter() - t0)
    return best


def phase_telemetry(dev):
    """The wave-level telemetry on the card, the port of the reference's
    ``benchmarks/telemetry_bench.py``: returns ``{"telemetry": {kernel:
    launches}}``, counted from 0 just before the wave-by-wave timer's runs
    and the measured trace CLI and read just after them.

    1. ``timing.wave_report`` of the pipelined and striped programs of the
       4x4 torus (k=2) and the 2x8 torus (k=1), at 4 MiB and at the full
       (16, 134,515,008) gradient: every wave's measured (CUDA events),
       host and predicted (the committed ``cuda`` row) times.
    2. ``timing.register_measured`` over every measured wave: the fitted
       ``cuda`` row, alpha >= 0 and link_bw finite and positive.
    3. ``python -m repro_torch.telemetry.trace --measured`` (its ``main``)
       on the torus; each trace it writes validates.
    4. The 2x8 torus's full-width pipelined program run wave by wave as
       the timer runs it (every reduce hop one combine of 16 x
       134,515,008 elements): its rows equal the engine's output bit for
       bit and ``x.sum(0)`` within 1e-4 of the largest sum.
    5. The full-width pipelined allreduce on the torus at S = 1, 2, 4, 8,
       interleaved: the S ``segments="auto"`` picks (with the fitted row,
       then with the committed one, the fit unregistered) within 5% of
       the fastest, beside each S's ``sum(CostModel.wave_times(
       segments=S))``.
    6. ``launch.train --trace-out`` of one full-width step on the torus:
       the trace validates, its spans timed by the committed ``cuda``
       row.
    7. The wave scopes: with scopes on and no profiler ``_scope`` opens
       no range, so a scoped allreduce runs the plain one's code and the
       reference bench's gate (scoped/plain <= 1.05) holds by
       construction; under a profiler it opens one.  What the ranges
       cost while the profiler a ``--profile-dir`` run opens records:
       each engine's allreduce on each torus at both payloads with
       ``set_wave_scopes(False)`` and ``(True)``, interleaved
       round-robin, scoped/plain logged.
    Peak memory under phase_elastic's 46.34 GB."""
    import torch
    from repro_torch.core.collectives import CostModel
    from repro_torch.dist import striped
    from repro_torch.dist import tree_allreduce as T
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.launch import train
    from repro_torch.telemetry import timing, trace
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"telemetry: {torch.cuda.memory_allocated() / 1e9:.2f} GB held "
        f"from before the phase")
    committed = dict(CostModel._BUILTIN["cuda"])
    log(f"telemetry: the committed cuda row {committed}")
    per_run = {}
    specs = {label: engine_specs(dims)
             for label, dims in TELEMETRY_TORI.items()}

    # 1. every wave of both programs of both tori, at both payloads
    reset_all()
    wires, secs = [], []
    for nbytes in TELEMETRY_NBYTES:
        for label in TELEMETRY_TORI:
            for engine in ("pipelined", "striped"):
                t0 = time.perf_counter()
                full = nbytes == 4 * N_PARAMS
                rep = timing.wave_report(specs[label][engine], nbytes,
                                         iters=3 if full else 5, device=dev)
                tag = f"telemetry waves {label} {engine} {nbytes} B"
                for w in range(rep["waves"]):
                    log(f"{tag}: w{w} wire {rep['wire_bytes'][w]} B, "
                        f"predicted {rep['predicted_us'][w]!r} us, measured "
                        f"{rep['measured_us'][w]!r} us, host "
                        f"{rep['host_us'][w]!r} us")
                log(f"{tag}: {rep['waves']} waves, {rep['summary']}, host "
                    f"total {sum(rep['host_us'])!r} us, "
                    f"{time.perf_counter() - t0!r}s")
                assert all(t > 0 and math.isfinite(t)
                           for t in rep["measured_us"] + rep["host_us"]), tag
                wires.extend(rep["wire_bytes"])
                secs.extend(t * 1e-6 for t in rep["measured_us"])
                torch.cuda.empty_cache()

    # 2. the fit over every measured wave
    row = timing.register_measured(wires, secs, backend="cuda")
    log(f"telemetry fit over {len(wires)} waves: {row}; registered "
        f"{CostModel.for_backend('cuda')}")
    assert row["alpha"] >= 0 and math.isfinite(row["link_bw"]) \
        and 0 < row["link_bw"] < 1e15, row

    # 3. the trace CLI, measured on the card
    out_dir = ROOT / "build" / "telemetry"
    shutil.rmtree(out_dir, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = trace.main(["--topology", "torus4x4", "--all-engines",
                         "--measured", "--out-dir", str(out_dir),
                         "--validate"])
    torch.cuda.synchronize()
    per_run["telemetry"] = c = counts()
    log(f"telemetry trace --measured: rc {rc}; "
        + "; ".join(out.getvalue().strip().splitlines()))
    assert rc == 0, out.getvalue()
    for engine in ("pipelined", "striped"):
        with open(out_dir / f"trace_torus4x4_{engine}.json") as f:
            tr = json.load(f)
        assert trace.validate_trace(tr) == [], engine
        assert any(e["ph"] == "X" and e["dur"] > 0
                   for e in tr["traceEvents"]), engine
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"telemetry launches (timer + trace CLI): {c}")
    assert c["tree_combine"] > 0, c

    # 4. the 2x8 full-width program wave by wave against the engine
    spec = specs["torus2x8"]["pipelined"]
    fabric = StackedFabric(N_VERT, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((N_VERT, N_PARAMS), generator=g, device=dev)
    want = x.sum(0)
    y = T.pipelined_tree_allreduce(x, spec, fabric, segments=1)
    assert torch.equal(y, y[:1].expand_as(y)), "2x8 engine rows differ"
    y = y[0].clone()              # every row the same: keep one
    prep, fns, finish = timing.wave_steps(spec, fabric, N_PARAMS)
    state = prep(x)
    for fn in fns:
        state = fn(state)
    out = finish(state)
    del state
    same = torch.equal(out, y.expand_as(out))
    del out
    err, scale = max_err(y, want), float(want.abs().max())
    log(f"telemetry 2x8 torus wave by wave at (16, {N_PARAMS}): "
        f"{len(fns)} waves, rows equal to the engine's {same}, max|err| "
        f"against x.sum(0) {err!r} (limit 1e-4 * {scale!r})")
    assert same, "the wave-by-wave rows differ from the engine's"
    assert err <= 1e-4 * scale, (err, scale)
    del y, want
    torch.cuda.empty_cache()

    # 5. S in {1, 2, 4, 8} at full width against the auto pick
    spec = specs["torus4x4"]["pipelined"]
    mrow = -(-N_PARAMS // spec.k)
    fns = {s: (lambda s=s: T.pipelined_tree_allreduce(x, spec, fabric,
                                                      segments=s))
           for s in SWEEP_SEGMENTS}
    best = best_of(fns, 3)
    fastest = min(best.values())
    rows = {"fitted": CostModel.for_backend("cuda"),
            "committed": CostModel(**committed)}
    for s in SWEEP_SEGMENTS:
        pred = {which: sum(cm.wave_times(spec, 4 * N_PARAMS, segments=s))
                for which, cm in rows.items()}
        log(f"telemetry segments S={s}: {best[s]!r}s "
            f"({best[s] / fastest!r} of the fastest); predicted {pred}")
    picks = {"fitted": T.auto_segments(spec, mrow, dev)}
    CostModel._MEASURED.pop("cuda")
    picks["committed"] = T.auto_segments(spec, mrow, dev)
    for which, s in picks.items():
        ratio = best[s] / fastest if s in best else math.inf
        log(f"telemetry auto segments ({which} row): S={s}, "
            f"{ratio!r} of the fastest (<= 1.05)")
        assert ratio <= 1.05, (which, s, best)
    assert T.resolve_codec("auto", dev) == "full"
    del x
    torch.cuda.empty_cache()

    # 6. one full-width training step's --trace-out
    path = ROOT / "build" / "sync_trace.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.main(["--arch", "smollm-135m", "--batch", "32", "--seq",
                          "256", "--device", "cuda", "--mesh", "4,4,1",
                          "--sync", "edst", "--steps", "1",
                          "--trace-out", str(path)], cfg=fault_loop_cfg())
    printed = [ln for ln in out.getvalue().splitlines()
               if "trace" in ln or "spans" in ln]
    with open(path) as f:
        tr = json.load(f)
    path.unlink()
    spans = [e for e in tr["traceEvents"] if e["ph"] == "X"]
    cm = rows["committed"]
    want = round((cm.alpha + spans[0]["args"]["wire_bytes"] / cm.link_bw)
                 * 1e6, 3)
    log(f"telemetry train --trace-out: {printed}; loss {res.losses}; "
        f"{len(spans)} spans, first {spans[0]['dur']!r} us (cuda row: "
        f"{want!r} us)")
    assert trace.validate_trace(tr) == [] and spans
    assert any("not the card's times" in ln for ln in printed), printed
    assert spans[0]["dur"] == want and \
        spans[0]["args"]["wire_bytes"] == 4 * (-(-N_PARAMS // 2))
    assert all(math.isfinite(v) for v in res.losses), res.losses
    del res, tr
    torch.cuda.empty_cache()

    # 7. the wave scopes, last: no range without a profiler; under one,
    # what the ranges cost at both payloads, both tori, both engines
    prev = T.set_wave_scopes(True)
    assert isinstance(T._scope("edst/t0/w0/reduce"),
                      contextlib.nullcontext), "a range without a profiler"
    x = torch.randn((N_VERT, N_PARAMS), generator=g, device=dev)
    prof = train.profiler(dev)
    prof.start()
    assert not isinstance(T._scope("edst/t0/w0/reduce"),
                          contextlib.nullcontext), "no range under a profiler"
    T.set_wave_scopes(prev)
    for nbytes in TELEMETRY_NBYTES:
        elems = nbytes // 4
        xs = x[:, :elems]
        xs = xs if elems == N_PARAMS else xs.contiguous()
        for label in TELEMETRY_TORI:
            for engine in ("pipelined", "striped"):
                sp = specs[label][engine]

                def call(scoped, sp=sp, xs=xs, engine=engine):
                    prev = T.set_wave_scopes(scoped)
                    try:
                        if engine == "striped":
                            striped.striped_allreduce(xs, sp, fabric)
                        else:
                            T.pipelined_tree_allreduce(xs, sp, fabric,
                                                       segments=1)
                    finally:
                        T.set_wave_scopes(prev)

                best = best_of({"plain": lambda: call(False),
                                "scoped": lambda: call(True)},
                               3 if nbytes == 4 * N_PARAMS else 20)
                log(f"telemetry scopes under the profiler {label} {engine} "
                    f"{nbytes} B: plain {best['plain']!r}s, scoped "
                    f"{best['scoped']!r}s, scoped/plain "
                    f"{best['scoped'] / best['plain']!r}")
        del xs
    prof.stop()
    del x, prof
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    log(f"telemetry phase: {time.perf_counter() - t_phase!r}s, peak memory "
        f"{peak / 1e9:.2f} GB (limit {TELEMETRY_PEAK / 1e9:.2f})")
    assert peak < TELEMETRY_PEAK, peak
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
    secs = {}

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        return out

    timed_phase("build", phase_build)
    # the host's dry run beside the card's phases (it uses one CPU core)
    dryrun = start_dryrun()
    rows = timed_phase("kernels", lambda: phase_kernels(dev) + [
        phase_flash(dev), phase_rglru(dev), phase_wkv6(dev)])

    # the main paths, each run counted on its own
    phases = {"allreduce": timed_phase("allreduce", phase_allreduce, dev),
              "train": timed_phase("train", phase_train, dev)}
    phases["train"].update(timed_phase("train", phase_train_families, dev))
    for name, fn in (("serve", phase_serve), ("zero1", phase_zero1),
                     ("elastic", phase_elastic),
                     ("telemetry", phase_telemetry),
                     # last: the NCCL group's memory outside PyTorch's pool
                     # (its comm and streams) would take from the serving
                     # phase's f32 checks, which fill the card to within 1 GB
                     ("fabric", phase_fabric)):
        phases[name] = timed_phase(name, fn, dev)
    # the training direction of flash attention, beside its forward's row:
    # its plain versions at the train shapes take some 30 GB in large
    # blocks, which the training phases' allocations would have to share
    # (recurrentgemma-2b's profiled step ran out of memory behind them)
    flash_at = [r["name"] for r in rows].index("flash_attention") + 1
    rows[flash_at:flash_at] = timed_phase("kernels", phase_flash_train, dev)
    # host ranks, after every timed phase of the card
    phases["gloo gspmd"] = timed_phase("gloo gspmd", phase_gloo_gspmd, dev)
    dry_s = timed_phase("dryrun wait", finish_dryrun, dryrun)
    log(f"dryrun subprocess seconds (beside the card's phases): {dry_s!r}")
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in secs.items()))
    per_run = {tag: c for runs in phases.values() for tag, c in runs.items()}
    by_phase = {ph: {name: sum(c[name] for c in runs.values())
                     for name in counts()} for ph, runs in phases.items()}
    launches = {name: sum(c[name] for c in per_run.values())
                for name in counts()}
    log(f"launches over the allreduce, training (smollm-135m and the other "
        f"token families), process-group fabric, serving, zero1, elastic "
        f"and telemetry runs: {launches}; by phase: {by_phase}")
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on its path"
    for name in ("tree_combine", "q8_pack_rows", "q8_unpack_rows"):
        assert by_phase["fabric"][name] > 0, (name, by_phase["fabric"])
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["launches_by_phase"] = {ph: c[r["name"]]
                                  for ph, c in by_phase.items()}
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
