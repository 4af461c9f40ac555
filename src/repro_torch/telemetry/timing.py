"""Measured wave timing: the wave-by-wave instrumented executor (the port's
counterpart of the reference's ``repro.telemetry.timing``).

The production executors run a compiled program's waves back to back, so
the end-to-end time of an allreduce says nothing about *which* waves
dominate.  This module re-runs the SAME wave bodies on a fabric (a
:class:`~repro_torch.dist.fabric.StackedFabric`, or with ``group=`` a
:class:`~repro_torch.dist.fabric.ProcessGroupFabric`) -- the pipelined engine's
S=1 f32 wave (``_select_payload``, ``fabric.ppermute``, ``_apply_wave``,
whose reduce hops launch the tree-combine kernel through ``_acc``) and the
striped engine's ``_run_wave`` -- one wave at a time with a synchronize
after each, yielding per-wave durations to set against the
:class:`repro_torch.core.collectives.CostModel`'s per-wave predictions
(``CostModel.wave_times``).  :func:`register_measured` feeds the fitted
``alpha``/``link_bw`` back into the calibration registry
(``CostModel.register_calibration``).

On CUDA a wave's time is read from CUDA events recorded around it (the
device's time from the wave's first launch to its last, gaps between its
launches included); the host clock around the same wave, from before its
first launch to after the synchronize, is kept beside it.  On the CPU
the timer uses the host clock.  Nothing moves to the CPU unless the
caller asks for ``device="cpu"``: without a CUDA device a CUDA request
raises.

Where the reference keeps every wave's input state and times each wave
on its stored input, a full-width state here is several GB (the 4x4
torus's (16, 134,515,008) gradient: 13 states of 8.6 GB), and the
striped engine writes its state in place.  So the program runs in
*passes*: each pass builds the payload and the input state anew and
runs the waves in order, timing each as it runs, so every wave is still
timed against its true input, and no copy of the payload outlives the
waves that need it.  The first pass warms up (kernel loads, the memory pool); the
best of ``iters`` further passes is kept per wave.

Over the ranks of a group each rank runs the waves on its own block of
the payload's rows; a barrier precedes every wave, so each wave starts
together on every rank, and a wave's time is the maximum over the ranks
(one ``all_reduce`` MAX a pass, after its last wave): every rank returns
the same times, and rank 0 reports them.

The ``backend`` of a calibration here is the torch device type
(``"cuda"``, ``"cpu"``), where the reference's is JAX's backend name
(``"gpu"`` on the same card).  A stacked fabric's "link" is a gather in
one card's memory, so a ``cuda`` row describes one card, not a link
between cards.  The reference's ``ensure_devices`` and ``_mesh_for``
have no counterpart: the port has no fake-device mesh.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..core.collectives import (CostModel, PipelinedAllreduceSpec,
                                StripedCollectiveSpec, striped_tables,
                                wave_wire_bytes)
from ..core.device import resolve_device
from ..dist.fabric import ProcessGroupFabric, StackedFabric
from ..dist.striped import _rows_in, _run_wave
from ..dist.tree_allreduce import (_apply_wave, _row_sizes, _rows_of,
                                   _rows_out, _select_payload)

DEFAULT_NBYTES = 4 << 20
DEFAULT_ITERS = 5


def _pipelined_steps(spec, fabric, size: int, fractions):
    """``(prep, wave fns, finish)`` of the pipelined engine's S=1 f32
    program over ``(n, size)`` payloads: the state is the list of k
    ``(n, mrow)`` chunk rows."""
    sizes, mrow = _row_sizes(size, spec.k, fractions)

    def prep(x):
        return _rows_of(x.reshape(fabric.rows, -1), sizes, mrow)

    def wave_step(wv):
        def step(rows):
            payload = _select_payload(rows, wv.rows, wv.send_row, fabric)
            recv = fabric.ppermute(payload, wv.perm)
            return _apply_wave(rows, wv, recv, fabric)
        return step

    def finish(rows):
        return _rows_out(rows, sizes, size)

    return prep, [wave_step(wv) for wv in spec.waves], finish


def _striped_steps(spec, fabric, size: int, fractions):
    """``(prep, wave fns, finish)`` of the striped engine's composed f32
    RS/AG program: the state is the ``(n, k, mrow)`` row stack, which
    every wave writes in place."""
    fr = None if fractions is None else tuple(fractions)
    bound = striped_tables(spec, size, fr)

    def prep(x):
        return _rows_in(x.reshape(fabric.rows, -1), bound.sizes, bound.mrow)

    def wave_step(bw):
        def step(state):
            return _run_wave(state, bw, fabric, None, None)
        return step

    def finish(state):
        return _rows_out(list(state.unbind(1)), bound.sizes, size)

    return prep, [wave_step(bw) for bw in bound.waves], finish


def wave_steps(spec, fabric, size: int, fractions=None):
    """``(prep, wave fns, finish)`` of the spec's program over ``(rows,
    size)`` payloads of the fabric's local vertices: ``prep(x)`` builds
    the state, ``fns[w](state)`` runs wave w and returns the next state,
    ``finish(state)`` returns the ``(rows, size)`` sums -- the engine's
    own result, bit for bit."""
    if isinstance(spec, StripedCollectiveSpec):
        return _striped_steps(spec, fabric, size, fractions)
    if isinstance(spec, PipelinedAllreduceSpec):
        return _pipelined_steps(spec, fabric, size, fractions)
    raise NotImplementedError(
        "wave-by-wave timing instruments the production engines "
        "(pipelined, striped); use the edst/ profiler ranges for the "
        "fused/per-tree baselines")


def _timed_pass(prep, fns, payload, cuda: bool, fabric):
    """Run the program once on ``prep(payload())``, a barrier before and a
    synchronize after every wave; returns ``(device seconds, host
    seconds)`` per wave (device = host on the CPU).  The payload is made
    anew for the pass and held by nothing but the state, so it is freed
    as soon as no wave needs it."""
    state = prep(payload())
    dev, host = [], []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
    for fn in fns:
        fabric.barrier()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        state = fn(state)
        if cuda:
            end.record()
            torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        dev.append(start.elapsed_time(end) * 1e-3 if cuda else host[-1])
    del state
    return dev, host


def timed_waves(spec, nbytes: int = DEFAULT_NBYTES,
                iters: int = DEFAULT_ITERS, fractions=None,
                device="cuda", group=None) -> tuple:
    """``(device seconds, host seconds)`` per wave of the compiled program,
    each the best of ``iters`` passes after one warm-up pass, run wave by
    wave on a fabric on ``device`` (see the module docstring): stacked,
    or with ``group`` a process-group fabric of its ranks, each wave's
    time the maximum over them.  The payload is the reference's:
    ``arange(n * elems) * 1e-4`` in f32, ``elems = ceil(nbytes / 4)`` a
    vertex, each rank making its own rows."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    elems = max(1, -(-int(nbytes) // 4))
    fabric = StackedFabric(spec.n, dev) if group is None \
        else ProcessGroupFabric(spec.n, dev, group)
    prep, fns, _ = wave_steps(spec, fabric, elems, fractions)

    def payload():
        return (torch.arange(fabric.lo * elems, fabric.hi * elems,
                             dtype=torch.float32, device=dev)
                .reshape(fabric.rows, elems) * 1e-4)

    best_dev = [float("inf")] * len(fns)
    best_host = [float("inf")] * len(fns)
    for i in range(max(1, iters) + 1):
        d, h = _timed_pass(prep, fns, payload, cuda, fabric)
        if i == 0:
            continue                    # warm-up: kernel loads, the pool
        # the slowest rank's, on every rank (the identity when stacked)
        t = fabric.all_reduce(torch.tensor(d + h, dtype=torch.float64,
                                           device=dev),
                              dist.ReduceOp.MAX).tolist()
        d, h = t[:len(fns)], t[len(fns):]
        best_dev = [min(a, b) for a, b in zip(best_dev, d)]
        best_host = [min(a, b) for a, b in zip(best_host, h)]
    return tuple(best_dev), tuple(best_host)


def measured_wave_times(spec, nbytes: int = DEFAULT_NBYTES,
                        iters: int = DEFAULT_ITERS, fractions=None,
                        device="cuda") -> tuple:
    """Best-of-``iters`` measured seconds per wave of the compiled
    program (CUDA events on CUDA, the host clock on the CPU): the device
    half of :func:`timed_waves`."""
    return timed_waves(spec, nbytes, iters, fractions, device)[0]


def wave_report(spec, nbytes: int = DEFAULT_NBYTES,
                iters: int = DEFAULT_ITERS, fractions=None,
                cost_model=None, device="cuda") -> dict:
    """Per-wave measured-vs-predicted residuals for one compiled spec: the
    reference's row schema, plus ``host_us`` (the host clock around each
    wave) and ``device``.  The prediction defaults to the calibration of
    ``device``'s type (``CostModel.for_backend("cuda")`` on the card)."""
    from ..analysis.verify import engine_of
    dev = resolve_device(device)
    measured, host = timed_waves(spec, nbytes, iters, fractions, dev)
    cm = cost_model or CostModel.for_backend(dev.type)
    predicted = cm.wave_times(spec, nbytes, 4, fractions)
    wires = wave_wire_bytes(spec, nbytes, 4, fractions)
    meas_us = [t * 1e6 for t in measured]
    pred_us = [t * 1e6 for t in predicted]
    resid_us = [m - p for m, p in zip(meas_us, pred_us)]
    return {
        "engine": engine_of(spec),
        "device": dev.type,
        "waves": len(wires),
        "nbytes": int(nbytes),
        "wire_bytes": [int(w) for w in wires],
        "predicted_us": [round(v, 3) for v in pred_us],
        "measured_us": [round(v, 3) for v in meas_us],
        "host_us": [round(t * 1e6, 3) for t in host],
        "residual_us": [round(v, 3) for v in resid_us],
        "summary": {
            "predicted_total_us": round(sum(pred_us), 3),
            "measured_total_us": round(sum(meas_us), 3),
            "mean_abs_residual_us": round(
                sum(abs(r) for r in resid_us) / max(1, len(resid_us)), 3),
            "max_abs_residual_us": round(
                max((abs(r) for r in resid_us), default=0.0), 3),
        },
    }


def fit_calibration(wire_bytes, measured_s) -> dict:
    """Least-squares ``t = alpha + bytes / link_bw`` over measured waves
    (the CostModel's two constants).  Degenerate samples (fewer than two
    distinct wire widths, or a non-positive slope on noisy hosts) pin
    ``link_bw`` high so alpha alone carries the fit."""
    import numpy as np
    b = np.asarray(wire_bytes, dtype=float)
    t = np.asarray(measured_s, dtype=float)
    if b.size < 2 or np.ptp(b) == 0.0:
        return {"alpha": float(t.mean()) if t.size else 0.0,
                "link_bw": 1e15}
    slope, intercept = np.polyfit(b, t, 1)
    return {"alpha": max(float(intercept), 0.0),
            "link_bw": float(1.0 / slope) if slope > 0 else 1e15}


def register_measured(wire_bytes, measured_s, backend: str = "cuda") -> dict:
    """Fit a calibration from measured waves and feed it back into the
    registry ``CostModel.for_backend`` consults.  The backend's built-in
    constants that the fit does not give (``overlap``: the stacked
    fabric runs a step's waves one after another) are kept.  Returns the
    registered row (``{"backend", "alpha", "link_bw"}``)."""
    cal = fit_calibration(wire_bytes, measured_s)
    CostModel.register_calibration(
        backend, **{**(CostModel._BUILTIN.get(backend) or {}), **cal})
    return {"backend": backend, **cal}
