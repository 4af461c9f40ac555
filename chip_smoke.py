#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the tree-combine / int8 wire-codec kernels from the sources in this
checkout, holds each against its plain PyTorch version at the training
path's shapes (and at ragged small ones) and times it, sums a full-size
stacked gradient with the EDST engine (4x4 torus f32 and int8, ring 16
int8), and trains the full-width smollm-135m data-parallel over the 16
vertices of the 4x4 torus (edst, edst + int8 wire, psum_dp) and of the
ring 16 (edst + int8 wire, the fabric whose reduce hops run q8_combine).
Every failed check raises, so the exit code is non-zero and no result
line is printed.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

preceded by one JSON line ``{"kernels": [...]}`` (launches summed over
the training runs, each counted from 0 just before its run and read just
after it; times from CUDA events in this run) and the card's name and
power limit from nvidia-smi.

It needs a CUDA device and the repository around it; without either it
exits non-zero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
N_VERT = 16
N_PARAMS = 134_515_008         # smollm-135m, the stacked payload's width
M_ROW = N_PARAMS // 2          # one chunk row on the 4x4 torus (k=2)
# (rows, lanes) of every codec call on the training path: a torus reduce
# hop packs and unpacks 16 vertex rows of a chunk row; the torus's
# pack-once broadcast packs and finally unpacks 16 x 2 (vertex, tree)
# rows; on the ring (k=1) every pack, combine and unpack is 16 full
# gradients, more than 2^31 elements
CODEC_SHAPES = ((N_VERT, M_ROW), (2 * N_VERT, M_ROW), (N_VERT, N_PARAMS))


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def timed(fn, iters=5):
    """Mean ms of ``fn()`` over ``iters`` runs after one warm-up, by CUDA
    events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float((a - b).abs_().max())


def bound_ms(nbytes, ops):
    """The least time for the work: bytes over HBM rate or f32 operations
    over the f32 rate, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def phase_build():
    from repro_torch.kernels.tree_combine import kernel as K
    t0 = time.perf_counter()
    path = K.build()
    K._lib()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {K.BUILD_INFO.get('seconds', 0.0):.1f}s)")
    for line in K.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")


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
    for rows, m in ((1, 5), (3, 257), (32, 4099)):
        x = torch.randn((rows, m), generator=g, device=dev) * 3.3
        w = K.q8_pack_rows(x)
        assert torch.equal(w, R.q8_pack_rows_ref(x)), ("q8_pack", rows, m)
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
        ms, pms = timed(fn), timed(plain)
        lms = timed(library) if library is not None else None
        b, by = bound_ms(nbytes, ops)
        log(f"{name}: {ms:.3f} ms (bound {b:.3f} ms by {by}, plain "
            f"{pms:.3f} ms, library {lms if lms is None else round(lms, 3)}"
            f" ms), max_abs_err {err:g}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": f"{ref_file}:{line}", "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": b, "bound_by": by, "library_ms": lms})

    # the reduce-hop accumulate: recv (1, 16*m), partial (16*m,)
    length = N_VERT * M_ROW
    part = torch.randn((length,), generator=g, device=dev)
    recv = torch.randn((1, length), generator=g, device=dev)
    err = float((K.tree_combine(recv, part)
                 - R.tree_combine_ref(recv, part)).abs().max())
    assert err <= 1e-6, ("tree_combine", err)
    row("tree_combine", 36, err, lambda: K.tree_combine(recv, part),
        lambda: R.tree_combine_ref(recv, part),
        lambda: torch.add(part, recv[0]), 3 * length * 4, length)
    del part, recv
    torch.cuda.empty_cache()

    # the codec at every shape the path gives it, one shape at a time;
    # timed at the ring's, the largest and the only one of q8_combine_rows
    for shape in CODEC_SHAPES:
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


def phase_allreduce(dev):
    """Sum a random (16, 134,515,008) f32 payload with the stacked engine
    and hold it against ``payload.sum(0)``."""
    import torch
    from repro_torch.core import topologies as topo
    from repro_torch.core.collectives import (allreduce_schedule,
                                              pipelined_spec_from_schedule)
    from repro_torch.core.edst_star import star_edsts
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.tree_allreduce import pipelined_tree_allreduce
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((N_VERT, N_PARAMS), generator=g, device=dev)
    expect = x.sum(0)
    emax = float(expect.abs().max())
    # every int8 quantization errs by at most half a step, scale/2, and a
    # scale is at most max_i sum_v |x_v[i]| / 127 (partial sums never
    # exceed it); a total passes n-1 reduce packs and 1 broadcast pack
    sabs = float(x.abs().sum(0).max())
    fabric = StackedFabric(N_VERT, dev)
    for name, dims, codec in (("torus4x4", (4, 4), "off"),
                              ("torus4x4", (4, 4), "full"),
                              ("ring16", (16,), "full")):
        sp = topo.device_topology(dims)
        spec = pipelined_spec_from_schedule(
            allreduce_schedule(sp.n, star_edsts(sp).trees), ("a", "b"))
        secs, y = [], None
        for _ in range(2):      # the first call also grows the memory pool
            y = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = pipelined_tree_allreduce(x, spec, fabric,
                                         quantize=codec != "off", codec=codec)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        same = bool((y == y[0]).all())
        err = float((y[0] - expect).abs().max())
        del y
        if codec == "off":
            tol, rule = 1e-4 * emax, "1e-4 * max|sum|"
        else:
            tol = N_VERT * sabs / 254.0
            rule = "n * max_i sum_v|x_v[i]| / 254 (half step x hops)"
        log(f"allreduce {name} k={spec.k} waves={len(spec.waves)} "
            f"codec={codec}: {secs[0]!r}s then {secs[1]!r}s, max|err| {err:.3g} <= {tol:.3g} "
            f"[{rule}], rows identical {same}")
        assert same, (name, codec, "vertices disagree")
        assert err <= tol, (name, codec, err, tol)
    del x, expect
    torch.cuda.empty_cache()


def phase_train(dev):
    """Full-width smollm-135m through the training entry point, one run
    per path.  Every launch counter is set to 0 just before each run and
    read just after it; returns ``{run: {kernel: launches}}``."""
    import torch
    from repro_torch.kernels.tree_combine import kernel as K
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    base = ["--arch", "smollm-135m", "--batch", "32", "--seq", "256",
            "--log-every", "1", "--device", "cuda"]
    per_run = {}
    torch.cuda.reset_peak_memory_stats()

    def run(tag, extra, keep=False):
        K.reset_launches()
        t0 = time.perf_counter()
        res = train.main(base + extra, keep_first_step=keep)
        torch.cuda.synchronize()
        per_run[tag] = dict(K.LAUNCHES)
        dt = time.perf_counter() - t0
        assert all(math.isfinite(v) for v in res.losses), (tag, res.losses)
        log(f"train {tag}: losses {res.losses}, grad norms "
            f"{res.grad_norms}, s/step {res.step_seconds}, {dt!r}s in all, "
            f"launches {per_run[tag]}")
        return res

    def flat(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    edst = run("edst torus4x4", ["--mesh", "4,4,1", "--sync", "edst",
                                 "--steps", "3"], keep=True)
    p0, d_edst = flat(edst.init_params), flat(edst.first_step_params)
    gn_edst = edst.grad_norms[0]
    d_edst -= p0
    del edst
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
    rel = float((d_edst - d_psum).norm() / d_psum.norm())
    gn_rel = abs(gn_edst - psum.grad_norms[0]) / psum.grad_norms[0]
    log(f"edst vs psum_dp, step 1: |d_edst - d_psum| / |d_psum| {rel!r} "
        f"(<= 1e-5), max {float((d_edst - d_psum).abs().max())!r}; grad "
        f"norm {gn_edst!r} vs {psum.grad_norms[0]!r}, relative {gn_rel!r} "
        f"(<= 1e-6)")
    assert rel <= 1e-5, rel
    assert gn_rel <= 1e-6, gn_rel
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
    from repro_torch.kernels.tree_combine import kernel as K
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)

    phase_allreduce(dev)
    per_run = phase_train(dev)      # the main path: its launches count
    launches = {name: sum(c[name] for c in per_run.values())
                for name in K.LAUNCHES}
    log(f"launches over the training runs: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} never launched on the main path"
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
