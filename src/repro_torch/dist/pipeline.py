"""GPipe pipeline parallelism over a fabric's vertices (the reference's
``repro.dist.pipeline``).

``pipeline_apply`` runs the classic fill-steady-drain microbatch schedule:
stage s is vertex s of the fabric (a :class:`~repro_torch.dist.fabric.
StackedFabric` holds every stage on one device, a
:class:`~repro_torch.dist.fabric.ProcessGroupFabric` a block of them a
rank), microbatch m enters stage 0 at step m and reaches stage s at step
m + s, and activations hop stage -> stage + 1 through ``fabric.ppermute``.
After n_micro + n_stages - 1 steps the last stage has every output; a
``fabric.psum`` of the last stage's masked outputs replicates the
(n_micro, mb, ...) result to every stage, as the reference's masked
``psum`` does for its ``out_specs=P()``.

``bubble_fraction`` is the idle fraction of the schedule,
(S - 1) / (M + S - 1) -- the standard GPipe bubble; it is what the roofline
charges pipeline-parallel cells.
"""
from __future__ import annotations

import numpy as np
import torch


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule (0 when n_stages == 1)."""
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn, stage_params, x, fabric):
    """Apply ``fabric.n`` chained stages to ``n_micro`` microbatches.

    stage_fn: ``(local_params, h) -> h`` for the fabric's local stages at
    once: ``h`` is ``(rows, mb, ...)``, row i the input of stage
    ``fabric.vertices[i]``.
    stage_params: per-stage weights whose leading dimension is the
    fabric's local rows (stage ``fabric.vertices[i]``'s at index i).
    x: ``(n_micro, mb, ...)`` microbatched input, the same on every rank.
    Returns the final-stage outputs ``(n_micro, mb, ...)``, the same on
    every rank.
    """
    n_micro, n_stages = x.shape[0], fabric.n
    ids = np.arange(n_stages)
    is_first = fabric.column(ids == 0, x.ndim)
    is_last = fabric.column(ids == n_stages - 1, x.ndim + 1)
    fwd = [(s, s + 1) for s in range(n_stages - 1)]

    local = (fabric.rows,) + tuple(x.shape[1:])
    recv = x.new_zeros(local)
    outputs = x.new_zeros((fabric.rows,) + tuple(x.shape))
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t; everyone else consumes last hop
        x_t = x[t] if t < n_micro else x.new_zeros(x.shape[1:])
        h = stage_fn(stage_params, torch.where(is_first, x_t, recv))
        m = t - (n_stages - 1)
        if m >= 0:   # the last stage just finished microbatch m
            outputs[:, m] = torch.where(is_last[:, 0], h, outputs[:, m])
        if t < n_micro + n_stages - 2:
            recv = fabric.ppermute(h, fwd)
    # replicate the last stage's collected outputs to every stage
    return fabric.psum(torch.where(is_last, outputs, 0.0))[0]
