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

``zero1=True`` replaces the allreduce and the dense optimizer with the
ZeRO-1 pipeline: reduce-scatter the gradients onto owner stripes, run the
sharded AdamW of :mod:`repro_torch.optim.sharded` in the scattered
domain, and allgather only the updated params.  ``fault_runtime`` (see
:mod:`repro_torch.dist.fault`) makes the ``edst`` step failure-event
aware: it takes a schedule id selecting among precompiled healthy,
degraded and rebuilt tree programs, so a link failure is an id flip.
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
                                striped_spec_from_schedule, wave_wire_bytes)
from ..core.edst_star import star_edsts
from ..models.transformer import loss_fn
from ..optim.adamw import tree_leaves
from ..optim.sharded import ShardedAdamW, ShardedOptState, decay_mask
from .fabric import StackedFabric
from .fault import FaultAwareAllreduce
from .health import payload_checksum, replication_divergence
from .striped import (owner_stripes, rs_conservation_gap, tree_allgather,
                      tree_reduce_scatter)
from .tree_allreduce import tree_allreduce

DATA_AXES = ("pod", "data")
SYNC_MODES = ("psum_dp", "edst")
ENGINES = ("pipelined", "fused", "striped")


def dp_extent(mesh_shape, axis_names) -> int:
    return int(np.prod([int(s) for a, s in zip(axis_names, mesh_shape)
                        if a in DATA_AXES] or [1]))


def dp_fabric_for_mesh(mesh_shape, axis_names, dp_torus_shape=None):
    """The data-parallel fabric of a device mesh: (star_product, dp_axis_names).

    The DP fabric is the sub-mesh spanned by the ("pod", "data") axes; its
    physical graph is taken to be the torus over those extents (row-major
    vertex ids = flattened DP rank, matching ``device_topology``).
    ``dp_torus_shape`` overrides the physical shape when the logical mesh
    flattens it (product must equal the DP extent).
    """
    axis_names = tuple(axis_names)
    dims = [int(s) for a, s in zip(axis_names, mesh_shape)
            if a in DATA_AXES]
    names = tuple(a for a in axis_names if a in DATA_AXES)
    n = int(np.prod(dims)) if dims else 1
    if n <= 1:
        raise ValueError("mesh has no data-parallel extent to sync over")
    phys = tuple(int(d) for d in dp_torus_shape) if dp_torus_shape \
        else tuple(d for d in dims if d > 1)
    if int(np.prod(phys)) != n:
        raise ValueError(f"dp_torus_shape {phys} != DP extent {n}")
    return topo.device_topology(phys), names


@functools.lru_cache(maxsize=None)
def _edst_spec_cached(mesh_shape, axis_names, dp_torus_shape, engine,
                      schedule):
    sp, names = dp_fabric_for_mesh(mesh_shape, axis_names, dp_torus_shape)
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
        mesh_shape, axis_names, dp_torus_shape=None,
        engine: str = "pipelined", schedule: str = "greedy"
) -> PipelinedAllreduceSpec | FusedAllreduceSpec | StripedCollectiveSpec:
    """EDST allreduce spec for the data-parallel fabric of a device mesh
    (see :func:`dp_fabric_for_mesh`, and its ``dp_torus_shape``).
    ``engine`` picks the compiled form:
    ``"pipelined"`` (default: the list-scheduled segment-streaming wave
    program), ``"striped"`` (the reduce-scatter/allgather program of
    :mod:`repro_torch.dist.striped`: stripe-sized wires) or ``"fused"``
    (the round-aligned baseline).  ``schedule`` picks the wave-assembly
    strategy (``repro_torch.core.collectives.SCHEDULES``): ``"greedy"``
    list scheduling, ``"search"`` the seeded hillclimb, or ``"composed"``
    the compositional product-schedule compiler.  Cached by (mesh, axes,
    torus shape, engine, schedule): repeated calls, an elastic rescale's
    among them, return the same object."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    return _edst_spec_cached(
        tuple(mesh_shape), tuple(axis_names),
        None if dp_torus_shape is None else tuple(dp_torus_shape), engine,
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


def fault_runtime_for_mesh(mesh_shape, axis_names, dp_torus_shape=None,
                           engine: str = "pipelined") -> FaultAwareAllreduce:
    """Elastic EDST runtime (precompiled degraded/rebuilt failure-class
    schedules) for the data-parallel fabric of a device mesh.  Pass it to
    ``make_train_step(mode="edst", fault_runtime=...)`` and feed its
    schedule ids to the step's ``schedule_id`` argument.  ``engine``
    selects the compiled form of every failure class (striped classes
    re-stripe ownership over the surviving trees); ``dp_torus_shape`` as
    in :func:`dp_fabric_for_mesh`."""
    sp, names = dp_fabric_for_mesh(mesh_shape, axis_names, dp_torus_shape)
    return FaultAwareAllreduce.build(sp.product(), star_edsts(sp).trees,
                                     names, engine=engine)


_WIRE_TABLE_CACHE: dict = {}


def _entry_wire_table(entries, nbytes: int, itemsize: int) -> list:
    """Per-entry total wire bytes of a fault runtime's precompiled
    schedules, memoized on (spec keys, payload)."""
    key = (tuple((e.spec.key, e.fractions) for e in entries),
           int(nbytes), int(itemsize))
    hit = _WIRE_TABLE_CACHE.get(key)
    if hit is None:
        hit = _WIRE_TABLE_CACHE[key] = [
            float(sum(wave_wire_bytes(e.spec, nbytes, itemsize,
                                      e.fractions or None)))
            for e in entries]
    return hit


def _split_batch(batch, n: int) -> list:
    """The batch split evenly over the n DP vertices in row-major order,
    as ``shard_map`` splits it: every entry along its leading dim."""
    rows = {k: v.shape[0] for k, v in batch.items()}
    b = next(iter(rows.values()))
    if any(r != b for r in rows.values()) or b % n:
        raise ValueError(f"batch {rows} does not split over {n} "
                         f"data-parallel vertices")
    bl = b // n
    return [{k: v[i * bl:(i + 1) * bl] for k, v in batch.items()}
            for i in range(n)]


def _flat(tree) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in tree_leaves(tree)])


def make_train_step(cfg, opt, mesh_shape, axis_names, mode: str = "edst",
                    quantize: bool = False, engine: str = "pipelined",
                    segments="auto", zero1: bool = False,
                    fault_runtime: FaultAwareAllreduce | None = None,
                    telemetry: bool = False, codec=None, loss=None):
    """Build the train step for a mesh (see the module docstring).

    ``quantize`` sends int8 chunks over the trees where the device's codec
    policy allows it (off on the CPU, ``"full"`` on CUDA; see
    :func:`~repro_torch.dist.tree_allreduce.resolve_codec`); ``codec``
    overrides that policy for the zero1 gradient wires.  ``engine``
    (``mode="edst"``, ignored when a ``fault_runtime`` carries its own)
    selects the compiled allreduce form (see :func:`edst_spec_for_mesh`);
    ``segments`` streams the pipelined engine's chunks in that many
    segments (``"auto"``: see
    :func:`~repro_torch.dist.tree_allreduce.auto_segments`).  Every entry
    of the batch (``{"tokens": (B, S + 1)}`` for the model) is split
    evenly over the n DP vertices in row-major order, as ``shard_map``
    splits it.  ``loss`` replaces the model's loss: a callable
    ``(params, batch) -> (loss, aux)`` (default: ``loss_fn`` of ``cfg``).
    Returns metrics ``loss`` (mean over vertices), ``xent``,
    ``grad_norm`` and ``lr``.

    ``zero1=True`` (``mode="edst"``, striped engine) is the ZeRO-1 step:
    the gradients are ``tree_reduce_scatter``'d onto owner stripes,
    :class:`repro_torch.optim.sharded.ShardedAdamW` updates the params in
    the scattered domain (the clip norm a sum of per-vertex partial
    sums), and only the updated params are ``tree_allgather``'d back.
    ``opt_state`` is then a :class:`ShardedOptState` (build it with
    ``ShardedAdamW(opt).init_for(params, spec_or_runtime, n)``).

    ``fault_runtime`` (a :class:`repro_torch.dist.fault.FaultAwareAllreduce`,
    ``mode="edst"`` only) makes the step failure-event aware: its
    signature becomes ``step(params, opt_state, batch, schedule_id)``,
    ``schedule_id`` selecting among the runtime's precompiled programs
    (a bad id raises).  With zero1 a flip re-stripes the collectives in
    the step while ``fault_runtime.reshard_owned`` moves ``mu`` / ``nu``
    to the new owners outside it.

    ``telemetry=True`` adds, in every mode: ``sync_dev`` (the spread of a
    per-row payload checksum over the vertex rows of the synchronized
    gradients -- 0 when every replica holds the same sums; for zero1 the
    scattered domain's ``rs_conservation_gap``), ``sync_grad_norm``,
    ``sync_schedule_id`` and ``sync_wire_bytes`` (the EDST program's wire
    bytes, per entry with a fault runtime; 0 for ``psum_dp``); for zero1
    also ``ag_replicas_equal``: whether every vertex row of the
    allgathered params equals every other, bit for bit."""
    if mode not in SYNC_MODES:
        raise ValueError(f"mode {mode!r} not in {SYNC_MODES}")
    if fault_runtime is not None and mode != "edst":
        raise ValueError("fault_runtime requires mode='edst'")
    n = dp_extent(mesh_shape, axis_names)
    if zero1:
        if mode != "edst":
            raise ValueError("zero1=True requires mode='edst'")
        if n <= 1:
            raise ValueError("zero1=True needs a data-parallel extent > 1 "
                             "to shard optimizer state over")
        if fault_runtime is None and engine != "striped":
            raise ValueError("zero1=True requires engine='striped' (the "
                             "reduce-scatter/allgather split)")
    if fault_runtime is not None and n > 1 and fault_runtime.graph.n != n:
        raise ValueError(
            f"fault_runtime fabric n={fault_runtime.graph.n} != DP extent "
            f"{n}; rebuild it with fault_runtime_for_mesh")
    loss_of = loss if loss is not None else functools.partial(loss_fn, cfg)
    spec = fault_sync = z_rs = z_sl = z_ag = None
    if mode == "edst" and n > 1:
        if fault_runtime is not None:
            if zero1:
                z_rs, z_sl, z_ag = fault_runtime.make_zero1_sync(quantize,
                                                                 codec)
            else:
                fault_sync = fault_runtime.make_allreduce(quantize, segments)
        else:
            spec = edst_spec_for_mesh(mesh_shape, axis_names,
                                      engine=engine)
            if zero1:
                # the fault runtime's three primitives on the one healthy
                # spec (sid ignored); params allgather full precision
                def z_rs(g, sid, fabric):
                    return tree_reduce_scatter(g, spec, fabric,
                                               quantize=quantize, codec=codec)

                def z_sl(vec, sid):
                    return owner_stripes(vec, spec)

                def z_ag(owned, sid, shape, fabric):
                    return tree_allgather(owned, spec, fabric, shape)
    fabrics: dict = {}
    decay: dict = {}

    def fabric_on(dev):
        fabric = fabrics.get(dev)
        if fabric is None:
            fabric = fabrics[dev] = StackedFabric(n, dev)
        return fabric

    def wire_gauge(nbytes: int, itemsize: int, sid: int) -> float:
        if fault_runtime is not None:
            return _entry_wire_table(fault_runtime.entries, nbytes,
                                     itemsize)[sid]
        if spec is not None:
            return float(sum(wave_wire_bytes(spec, nbytes, itemsize)))
        return 0.0

    def local_grads(params, batch):
        """``(n, P)`` per-vertex gradients (row v: vertex v's loss on its
        batch shard) and the per-vertex losses."""
        parts = _split_batch(batch, n)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        size = sum(p.numel() for p in leaves)
        grads = torch.empty((n, size), dtype=leaves[0].dtype,
                            device=leaves[0].device)
        losses = []
        for v in range(n):
            lv, _ = loss_of(params, parts[v])
            off = 0
            for g in torch.autograd.grad(lv, leaves):
                grads[v, off:off + g.numel()] = g.reshape(-1)
                off += g.numel()
            losses.append(lv.detach())
        return grads, torch.stack(losses).mean()

    def sync(g, sid):
        """(n, P) per-vertex gradients -> (P,) mean gradient, and the
        telemetry of the sync."""
        tel = {}
        if n == 1:
            out = g[0]
        elif mode == "psum_dp":
            out = g.sum(0) / n
            if telemetry:
                tel = {"sync_dev": 0.0, "sync_wire_bytes": 0.0}
        else:
            fabric = fabric_on(g.device)
            if fault_sync is not None:
                rows = fault_sync(g, sid, fabric)
            else:
                rows = tree_allreduce(g, spec, fabric, quantize=quantize,
                                      segments=segments)
            if telemetry:
                size = rows[0].numel()
                tel = {"sync_dev": float(replication_divergence(
                    payload_checksum(rows))),
                    "sync_wire_bytes": wire_gauge(
                        size * rows.element_size(), rows.element_size(),
                        sid)}
            out = rows[0] / n
        if telemetry:
            tel.setdefault("sync_dev", 0.0)
            tel.setdefault("sync_wire_bytes", 0.0)
            tel["sync_grad_norm"] = float(out.float().norm())
            tel["sync_schedule_id"] = sid
        return out, tel

    def dense_step(params, opt_state, batch, sid):
        grads, loss = local_grads(params, batch)
        flat, tel = sync(grads, sid)
        del grads
        new_params, new_state, om = opt.apply(
            _detach(params), _unflatten(flat, params), opt_state)
        return new_params, new_state, {"loss": loss, "xent": loss, **om,
                                       **tel}

    sopt = ShardedAdamW(opt)

    def zero1_step(params, opt_state, batch, sid):
        grads, loss = local_grads(params, batch)
        fabric = fabric_on(grads.device)
        owned_g = z_rs(grads, sid, fabric) / n
        tel = {}
        if telemetry:
            tel["sync_dev"] = float(rs_conservation_gap(
                grads.float().sum(1) / n, owned_g))
            tel["sync_wire_bytes"] = wire_gauge(
                grads[0].numel() * grads.element_size(),
                grads.element_size(), sid)
        del grads
        flat_p = _flat(params).float()
        dev = flat_p.device
        if dev not in decay:
            decay[dev] = decay_mask(params, opt.weight_decay)
        owned_p = z_sl(flat_p, sid)
        owned_d = z_sl(decay[dev], sid)
        step = opt_state.step + 1
        gnorm = torch.sqrt(sopt.partial_sumsq(owned_g).sum())
        new_op, mu, nu, lr = sopt.update_stripes(
            owned_p, owned_g, owned_d, opt_state.mu, opt_state.nu, step,
            gnorm)
        del owned_g, owned_p, owned_d
        rows = z_ag(new_op, sid, flat_p.shape, fabric)
        del new_op
        if telemetry:
            tel["ag_replicas_equal"] = all(
                torch.equal(rows[v], rows[0]) for v in range(1, n))
            tel["sync_grad_norm"] = float(gnorm)
            tel["sync_schedule_id"] = sid
        new_flat = rows[0].clone()
        del rows
        new_params = _unflatten(new_flat, params)
        return new_params, ShardedOptState(step, mu, nu), {
            "loss": loss, "xent": loss, "grad_norm": gnorm, "lr": lr,
            **tel}

    body = zero1_step if zero1 else dense_step

    if fault_runtime is None:
        def step(params, opt_state, batch):
            return body(params, opt_state, batch, 0)
        return step

    # fault-aware contract: always 4 args; a bad id raises before any work
    def fault_step(params, opt_state, batch, schedule_id):
        return body(params, opt_state, batch,
                    fault_runtime.gate(schedule_id))
    return fault_step


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
