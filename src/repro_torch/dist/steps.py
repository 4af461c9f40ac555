"""Data-parallel train steps with selectable gradient synchronization (the
reference's ``repro/dist/steps.py``, manual sync modes).

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)`` for a mesh, with ``mode`` choosing how the
data-parallel gradients are combined:

  * ``"psum_dp"`` -- a plain sum over the replicas (the reference's
    ``jax.lax.psum``);
  * ``"edst"``    -- the k-tree allreduce over the paper's
    edge-disjoint spanning trees of the DP fabric
    (:func:`edst_spec_for_mesh`), through ``tree_allreduce`` in the
    compiled form ``engine`` names (:data:`ENGINES`).

The DP axes (``pod``, ``data``) form a :class:`StackedFabric` of n
vertices on one device.  Parameters are replicated, so one copy is held;
vertex v's loss and gradient on its batch shard are computed in turn into
row v of an ``(n, P)`` flat-gradient buffer, which is then summed across
vertices, divided by n and handed to AdamW.  The flat layout is the
reference's ``ravel_pytree`` order (sorted keys at every level, each leaf
in C order), so the EDST chunk rows and their int8 scales cover the same
elements as there.  A ``model`` axis is accepted and not replicated: the
reference's manual sync modes leave it unused.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import topologies as topo
from ..core.collectives import (FusedAllreduceSpec, PipelinedAllreduceSpec,
                                StripedCollectiveSpec, allreduce_schedule,
                                fused_spec_from_schedule,
                                pipelined_spec_from_schedule,
                                striped_spec_from_schedule)
from ..core.edst_star import star_edsts
from ..models.transformer import loss_fn
from ..optim.adamw import tree_leaves
from .fabric import StackedFabric
from .tree_allreduce import tree_allreduce

DATA_AXES = ("pod", "data")
SYNC_MODES = ("psum_dp", "edst")
ENGINES = ("pipelined", "fused", "striped")


def dp_extent(mesh_shape, axis_names) -> int:
    return int(np.prod([int(s) for a, s in zip(axis_names, mesh_shape)
                        if a in DATA_AXES] or [1]))


def dp_fabric_for_mesh(mesh_shape, axis_names):
    """The data-parallel fabric of a device mesh: (star_product, dp_axis_names).

    The DP fabric is the sub-mesh spanned by the ("pod", "data") axes; its
    physical graph is taken to be the torus over those extents (row-major
    vertex ids = flattened DP rank, matching ``device_topology``).
    """
    axis_names = tuple(axis_names)
    dims = [int(s) for a, s in zip(axis_names, mesh_shape)
            if a in DATA_AXES]
    names = tuple(a for a in axis_names if a in DATA_AXES)
    n = int(np.prod(dims)) if dims else 1
    if n <= 1:
        raise ValueError("mesh has no data-parallel extent to sync over")
    return topo.device_topology(tuple(d for d in dims if d > 1)), names


@functools.lru_cache(maxsize=None)
def _edst_spec_cached(mesh_shape, axis_names, engine, schedule):
    sp, names = dp_fabric_for_mesh(mesh_shape, axis_names)
    if schedule == "composed":
        # the compositional path never materializes the flat message DAG
        from ..core.product_schedule import composed_spec_for_star
        return composed_spec_for_star(sp, names, engine=engine)
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    if engine == "fused":
        return fused_spec_from_schedule(sched, names, schedule=schedule)
    if engine == "striped":
        return striped_spec_from_schedule(sched, names, schedule=schedule)
    return pipelined_spec_from_schedule(sched, names, schedule=schedule)


def edst_spec_for_mesh(
        mesh_shape, axis_names, engine: str = "pipelined",
        schedule: str = "greedy"
) -> PipelinedAllreduceSpec | FusedAllreduceSpec | StripedCollectiveSpec:
    """EDST allreduce spec for the data-parallel fabric of a device mesh
    (see :func:`dp_fabric_for_mesh`).  ``engine`` picks the compiled form:
    ``"pipelined"`` (default: the list-scheduled segment-streaming wave
    program), ``"striped"`` (the reduce-scatter/allgather program of
    :mod:`repro_torch.dist.striped`: stripe-sized wires) or ``"fused"``
    (the round-aligned baseline).  ``schedule`` picks the wave-assembly
    strategy (``repro_torch.core.collectives.SCHEDULES``): ``"greedy"``
    list scheduling, ``"search"`` the seeded hillclimb, or ``"composed"``
    the compositional product-schedule compiler.  Cached by (mesh, axes,
    engine, schedule): repeated calls return the same object."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    return _edst_spec_cached(tuple(mesh_shape), tuple(axis_names), engine,
                             schedule)


def _unflatten(flat, like):
    """Split a flat vector back into the tree of ``like`` (sorted-key
    order, C order within each leaf)."""
    off = 0

    def take(p):
        nonlocal off
        n = p.numel()
        out = flat[off:off + n].reshape(p.shape)
        off += n
        return out

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return take(t)
    return walk(like)


def make_train_step(cfg, opt, mesh_shape, axis_names, mode: str = "edst",
                    quantize: bool = False, engine: str = "pipelined",
                    segments="auto"):
    """Build the train step for a mesh (see the module docstring).

    ``quantize`` sends int8 chunks over the trees where the device's codec
    policy allows it (off on the CPU, ``"full"`` on CUDA; see
    :func:`~repro_torch.dist.tree_allreduce.resolve_codec`).  ``engine``
    (``mode="edst"``) selects the compiled allreduce form (see
    :func:`edst_spec_for_mesh`); ``segments`` streams the pipelined
    engine's chunks in that many segments (``"auto"``: see
    :func:`~repro_torch.dist.tree_allreduce.auto_segments`).  The batch
    ``{"tokens": (B, S + 1)}`` is split evenly over the n DP vertices in
    row-major order, as ``shard_map`` splits it.  Returns metrics
    ``loss`` (mean over vertices), ``xent``, ``grad_norm`` and ``lr``."""
    if mode not in SYNC_MODES:
        raise ValueError(f"mode {mode!r} not in {SYNC_MODES}")
    n = dp_extent(mesh_shape, axis_names)
    spec = None
    if mode == "edst" and n > 1:
        spec = edst_spec_for_mesh(mesh_shape, axis_names, engine=engine)
    fabrics: dict = {}

    def sync(g):
        """(n, P) per-vertex gradients -> (P,) mean gradient."""
        if n == 1:
            return g[0]
        if mode == "psum_dp":
            return g.sum(0) / n
        dev = g.device
        fabric = fabrics.get(dev)
        if fabric is None:
            fabric = fabrics[dev] = StackedFabric(n, dev)
        return tree_allreduce(g, spec, fabric, quantize=quantize,
                              segments=segments)[0] / n

    def step(params, opt_state, batch):
        tokens = batch["tokens"]
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"{n} data-parallel vertices")
        bl = tokens.shape[0] // n
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        size = sum(p.numel() for p in leaves)
        grads = torch.empty((n, size), dtype=leaves[0].dtype,
                            device=leaves[0].device)
        losses = []
        for v in range(n):
            loss, _ = loss_fn(cfg, params,
                              {"tokens": tokens[v * bl:(v + 1) * bl]})
            off = 0
            for g in torch.autograd.grad(loss, leaves):
                grads[v, off:off + g.numel()] = g.reshape(-1)
                off += g.numel()
            losses.append(loss.detach())
        flat = sync(grads)
        del grads
        new_params, new_state, om = opt.apply(
            _detach(params), _unflatten(flat, params), opt_state)
        loss = torch.stack(losses).mean()
        return new_params, new_state, {"loss": loss, "xent": loss, **om}

    return step


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
