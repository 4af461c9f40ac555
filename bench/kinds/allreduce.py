"""The ``allreduce`` traffic kind: back-to-back EDST allreduces of one
gradient payload through the program's ``tree_allreduce``.

The payload is ``(n, P)`` f32: n the vertices of the traffic's mesh's
data-parallel fabric, P the configuration's parameter count in the
program's layout, each vertex's row drawn from the seed (the same row
whichever rank holds it).  The spec is the program's
``edst_spec_for_mesh`` for the traffic's engine.  With ``ranks`` 1 the
rows sit stacked on one card (``StackedFabric``); with more, the run
spawns its other ranks and each holds its block of rows on a card of its
own (``ProcessGroupFabric`` over NCCL; gloo on the CPU), rank 0 printing
the result.

Set-up makes the rows once and warms the call; the window calls the
allreduce back to back, each call timed by CUDA events around it (on
several cards a call's time is its slowest rank's), until ``--seconds``
have passed.  The outputs of one call drawn from the seed among the
window's first four and of the window's last call are kept; once the
window has closed each of their rows is held to the plain reference, the
rows summed in f64 (``max_rel_err``: the widest gap over the reference's
largest magnitude).
"""
from __future__ import annotations

import datetime
import gc
import math
import socket
import statistics
import time
from contextlib import nullcontext

import counts
import harness
import modelcfg
import tracecut
import weights

JOIN_S = 330          # how long rank 0 waits for a spawned rank to end


def payload_width(config: dict) -> int:
    return sum(math.prod(s) for _, s in modelcfg.param_shapes(config))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(cell, config, traffic, limits, seed, seconds, trace, t0,
        device="cuda", plant=None):
    """One run of an allreduce cell; spawns ranks 1.. where the traffic
    asks for several and runs rank 0 here.  ``plant`` (tests only, one
    rank) wraps the allreduce."""
    world = traffic["ranks"]
    if world == 1:
        return rank_main(0, 1, None, config, traffic, limits, seed, seconds,
                         trace, t0, device, plant)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, init, config, traffic, limits, seed,
                               seconds, trace, t0, device, plant))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = rank_main(0, world, init, config, traffic, limits, seed,
                        seconds, trace, t0, device, plant)
    finally:
        for p in procs:
            p.join(JOIN_S)
        left = [p for p in procs if p.is_alive()]
        for p in left:
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if left or any(codes):
        raise SystemExit(f"bench: spawned ranks ended with {codes}")
    return out


def rank_main(rank, world, init, config, traffic, limits, seed, seconds,
              trace, t0, device, plant):
    import torch
    import torch.distributed as dist
    harness.program_path()
    torch.set_num_threads(2)
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if world > 1:
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init,
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=240), **kw)
    try:
        return _rank(rank, world, dev, config, traffic, limits, seed,
                     seconds, trace, t0, plant)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Timer:
    """Per-call times: CUDA events on the card, the host clock on the
    CPU (tests)."""

    def __init__(self, dev):
        import torch
        self.cuda = dev.type == "cuda"
        self.pairs = []
        self._torch = torch

    def start(self):
        if self.cuda:
            e = self._torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, begin):
        if self.cuda:
            e = self._torch.cuda.Event(enable_timing=True)
            e.record()
            e.synchronize()
            self.pairs.append((begin, e))
        else:
            self.pairs.append((begin, time.perf_counter()))

    def ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.pairs]
        return [(b - a) * 1e3 for a, b in self.pairs]


def _rank(rank, world, dev, config, traffic, limits, seed, seconds, trace,
          t0, plant):
    import torch
    import torch.distributed as dist
    from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
    from repro_torch.dist.steps import edst_spec_for_mesh
    from repro_torch.dist.tree_allreduce import tree_allreduce
    from repro_torch.kernels.tree_combine import kernel as tc_kernel
    from repro_torch.dist import tree_allreduce as tc_engine
    from repro_torch.telemetry import metrics as tmetrics
    mesh = tuple(traffic["mesh"])
    names = ("pod", "data", "model")[-len(mesh):]
    spec = edst_spec_for_mesh(mesh, names, engine=traffic["engine"])
    n = spec.n
    width = payload_width(config)
    fabric = StackedFabric(n, dev) if world == 1 \
        else ProcessGroupFabric(n, dev)
    x = torch.empty((fabric.rows, width), dtype=torch.float32, device=dev)
    for j, v in enumerate(range(fabric.lo, fabric.hi)):
        weights.payload_row(seed, v, width, dev, out=x[j])

    def call(inp):
        return tree_allreduce(inp, spec, fabric, segments=traffic["segments"])

    if plant is not None:
        call = plant(call, fabric)
    combine = counts.KernelBytes()
    target = (tc_kernel, "tree_combine") if dev.type == "cuda" \
        else (tc_engine, "combine")
    for i in range(traffic["warm_calls"]):
        with combine.recording(*target) if i == 1 else nullcontext():
            y = call(x)
        del y
    _sync(dev)
    if world > 1:
        dist.barrier()
    setup_s = time.perf_counter() - t0
    if rank == 0:
        harness.log(t0, f"rows made and {traffic['warm_calls']} calls warmed")
    wire_bytes = tmetrics.gauge("edst_wire_bytes").value(
        engine=traffic["engine"])

    # the window
    timer = _Timer(dev)
    sample = weights.sub_seed(seed, "sample") % 4
    kept = {}
    flag = torch.ones(1, device=dev)
    calls = 0
    start = time.perf_counter()
    while True:
        begin = timer.start()
        y = call(x)
        timer.stop(begin)
        if calls == sample:
            kept["sampled"] = y
        calls += 1
        go = time.perf_counter() - start < seconds
        if world > 1:
            flag.fill_(float(go))
            dist.broadcast(flag, 0)
            go = bool(flag.item())
        if not go:
            kept["last"] = y
            break
        del y
    window_s = time.perf_counter() - start
    del y
    if rank == 0:
        harness.log(t0, f"window: {calls} calls in {window_s!r} s")
    call_ms = timer.ms()
    if world > 1:
        t = torch.tensor(call_ms, device=dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        call_ms = torch.stack(parts).amax(0).tolist()

    summary = None
    if trace:
        with tracecut.profiled(dev.type) as prof:
            with torch.profiler.record_function(tracecut.SLICE):
                for i in range(traffic["trace_calls"]):
                    with torch.profiler.record_function(
                            f"{tracecut.UNIT}{i}"):
                        y = call(x)
                        _sync(dev)
                    del y
        summary = tracecut.summarize(tracecut.events_of(prof))
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rows = fabric.rows
    del x, fabric, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from reference.allreduce import max_rel_err
    ref = reference_sum(seed, n, width, dev)
    errs = [max_rel_err(y, ref) for y in kept.values()]
    del kept, ref
    forbidden = harness.forbidden_modules()
    mine = {"errs": errs, "peak": peak, "forbidden": forbidden,
            "summary": summary}
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    if rank != 0:
        return None
    errs = [max(e) for e in zip(*(r["errs"] for r in every))]
    checks = [("max_rel_err", max(errs), limits["max_rel_err"])]
    sums = [r["summary"] for r in every if r["summary"] is not None]
    if sums:
        summary = dict(sums[0])
        summary["busy_s"] = statistics.fmean(s["busy_s"] for s in sums)
        summary["window_s"] = statistics.fmean(s["window_s"] for s in sums)
    ctx = {"kind": "allreduce", "setup_s": setup_s,
           "window": {"seconds": window_s, "count": calls,
                      "call_ms": call_ms, "payload_bytes": 4 * width},
           "trace": summary, "world": world,
           "counts": {"rows": rows, "width": width,
                      "wire_bytes": wire_bytes,
                      "combine_bytes_per_unit": combine.bytes}}
    device_info = harness.device_record(
        dev, world, max(r["peak"] for r in every), summary)
    return {"correct": harness.within(checks), "attempted": calls,
            "failed": sum(not e <= limits["max_rel_err"] for e in errs),
            "checks": checks, "ctx": ctx, "device": device_info,
            "breakdown": summary["breakdown"] if summary else None,
            "forbidden": sorted({m for r in every for m in r["forbidden"]})}


def reference_sum(seed, n, width, dev):
    from reference.allreduce import row_sum
    return row_sum(lambda v, out: weights.payload_row(seed, v, width, dev,
                                                      out=out),
                   n, width, dev)

