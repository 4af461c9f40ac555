"""Data-parallel train steps with selectable gradient synchronization (the
reference's ``repro/dist/steps.py``).

``make_train_step(api, ...)`` builds ``step(params, opt_state, batch) ->
(params, opt_state, metrics)`` for a mesh and a model (a
:class:`repro_torch.models.api.ModelAPI`: its ``loss_fn`` is the loss),
with ``mode`` choosing how the data-parallel gradients are combined:

  * ``"gspmd"``   -- the loss of the whole global batch and its gradient,
    with no manual sync (the reference leaves the sum to XLA's
    partitioner): on one device it holds the whole batch; over the ranks
    the parameters are DTensors on a ``DeviceMesh`` (placed by
    :mod:`repro_torch.dist.sharding`'s rules: tensor-parallel over
    ``model``, FSDP over the data axes), the batch is split over the data
    axes, and DTensor's sharding propagation issues the collectives;
  * ``"psum_dp"`` -- a plain sum over the replicas (the reference's
    ``jax.lax.psum``);
  * ``"edst"``    -- the k-tree allreduce over the paper's
    edge-disjoint spanning trees of the DP fabric
    (:func:`edst_spec_for_mesh`), through ``tree_allreduce`` in the
    compiled form ``engine`` names (:data:`ENGINES`).

For the manual modes the DP axes (``pod``, ``data``) form a fabric of n
vertices: a :class:`StackedFabric` on one device, or, over the ranks of a
``torch.distributed`` group, a :class:`ProcessGroupFabric` whose rank r
holds a contiguous block of them (one vertex a rank is the reference's
``shard_map`` layout).  Parameters are replicated, so each rank holds one
copy; each local vertex's loss and gradient on its batch shard are
computed in turn into its row of a ``(rows, P)`` flat-gradient buffer,
which is then summed across all n vertices, divided by n and handed to
AdamW, so every rank ends a step with the same parameters.  The flat
layout is the reference's ``ravel_pytree`` order (sorted keys at every
level, each leaf in C order), so the EDST chunk rows and their int8
scales cover the same elements as there.  A ``model`` axis is accepted
and not replicated by the stacked step: the reference's manual sync modes
leave it unused.
``grad_accum`` splits each vertex's shard (the whole batch under
``gspmd``) into that many microbatches, whose mean gradient is the
shard's.

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
import torch.distributed as dist

from ..core import topologies as topo
from ..core.collectives import (FusedAllreduceSpec, PipelinedAllreduceSpec,
                                StripedCollectiveSpec, allreduce_schedule,
                                fused_spec_from_schedule,
                                pipelined_spec_from_schedule,
                                striped_spec_from_schedule, wave_wire_bytes)
from ..core.edst_star import star_edsts
from ..optim.adamw import tree_leaves
from ..optim.sharded import ShardedAdamW, ShardedOptState, decay_mask
from .fabric import (ProcessGroupFabric, StackedFabric, gather_blocks,
                     vertex_blocks, world_size)
from .fault import FaultAwareAllreduce
from .health import payload_checksum, replication_divergence
from .striped import (owner_stripes, rs_conservation_gap, tree_allgather,
                      tree_reduce_scatter)
from .tree_allreduce import tree_allreduce

DATA_AXES = ("pod", "data")
SYNC_MODES = ("gspmd", "psum_dp", "edst")
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
    return _unflatten_at(flat, like, 0)[0]


def _unflatten_at(flat, like, off: int):
    """``(tree, next offset)`` of :func:`_unflatten` from ``off``: a plain
    recursive function, since a recursive closure is a reference cycle
    that would hold ``flat`` until the cycle collector runs."""
    if isinstance(like, dict):
        out = {}
        for k in sorted(like):
            out[k], off = _unflatten_at(flat, like[k], off)
        return out, off
    n = like.numel()
    return flat[off:off + n].reshape(like.shape), off + n


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


def _split_batch(batch, n: int, what: str = "data-parallel vertices"
                 ) -> list:
    """The batch split evenly into n contiguous parts in row-major order,
    as ``shard_map`` splits it over the vertices and the reference's
    ``grad_accum`` reshape splits a shard into microbatches: every entry
    along its leading dim."""
    rows = {k: v.shape[0] for k, v in batch.items()}
    b = next(iter(rows.values()))
    if any(r != b for r in rows.values()) or b % n:
        raise ValueError(f"batch {rows} does not split over {n} {what}")
    bl = b // n
    return [{k: v[i * bl:(i + 1) * bl] for k, v in batch.items()}
            for i in range(n)]


def _flat(tree) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in tree_leaves(tree)])


def _mean_aux(auxs: list) -> dict:
    """The mean of each metric over a list of metric dicts."""
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def make_train_step(api, opt, mesh_shape, axis_names, mode: str = "edst",
                    quantize: bool = False, engine: str = "pipelined",
                    segments="auto", zero1: bool = False,
                    fault_runtime: FaultAwareAllreduce | None = None,
                    telemetry: bool = False, codec=None, grad_accum: int = 1,
                    loss=None, group=None, fsdp: bool = True):
    """Build the train step of ``api`` (a
    :class:`repro_torch.models.api.ModelAPI`) for a mesh (see the module
    docstring).

    ``quantize`` sends int8 chunks over the trees where the device's codec
    policy allows it (off on the CPU, ``"full"`` on CUDA; see
    :func:`~repro_torch.dist.tree_allreduce.resolve_codec`); ``codec``
    overrides that policy for the zero1 gradient wires.  ``engine``
    (``mode="edst"``, ignored when a ``fault_runtime`` carries its own)
    selects the compiled allreduce form (see :func:`edst_spec_for_mesh`);
    ``segments`` streams the pipelined engine's chunks in that many
    segments (``"auto"``: see
    :func:`~repro_torch.dist.tree_allreduce.auto_segments`).  Every entry
    of the batch (``{"tokens": (B, S + 1)}`` for the token families) is
    split evenly over the n DP vertices in row-major order, as
    ``shard_map`` splits it (``gspmd`` keeps it whole), and each part
    into ``grad_accum`` microbatches: the loss, the gradient and each
    metric of the loss are their means over the microbatches, as in the
    reference's ``local_loss_and_grads``.  ``loss`` replaces
    ``api.loss_fn``: a callable ``(params, batch) -> (loss, metrics)``
    (``api`` may then be ``None``).  Returns metrics ``loss`` (mean over
    vertices), ``grad_norm``, ``lr`` and the loss's own metrics
    (``xent``, the MoE's ``moe_load_balance`` and ``moe_router_z``),
    each averaged over the vertices.

    ``group`` (a ``torch.distributed`` process group; the default group
    when ``torch.distributed`` is initialised with more than one rank)
    runs the step over its ranks: each computes its block of vertices
    (:func:`~repro_torch.dist.fabric.vertex_blocks`), ``edst`` syncs
    through the engine on a :class:`ProcessGroupFabric`, and ``psum_dp``
    sums its local rows and ``all_reduce``s the sum (the reference's
    ``psum``).  The loss and the metrics are gathered in vertex order, so
    ``edst`` equals the stacked step bit for bit; ``psum_dp`` associates
    the gradient's sum over the ranks otherwise, and agrees with it
    within f32 rounding.

    ``gspmd`` over the ranks runs on DTensors (:func:`_gspmd_body`): with
    parameters that are DTensors (placed by
    :func:`repro_torch.dist.sharding.tree_shardings`, as the reference's
    ``train.py`` places them), the batch is split over the mesh's data
    axes, each parameter is gathered over the data axes where it is used
    (``fsdp``: its FSDP split is undone for the forward and the gradient
    reduce-scattered back onto it; the ``model`` split stays, so the
    products run tensor-parallel), and AdamW updates the shards; the
    returned parameters and moments keep the placements.  Plain
    parameters are taken as replicated on a one-axis ``data`` mesh over
    ``group`` and come back plain.  The loss, the grad norm and the
    metrics are full values, equal on every rank.  ``fsdp`` is the
    reference's flag; as there, the caller's placements decide, and
    ``fsdp=False`` leaves the parameters as placed.  ``zero1``, ``fault_runtime`` and
    ``telemetry`` run over the ranks too, bit for bit with the stacked
    step: each rank holds the optimizer state of its own vertices, the
    clip norm and the telemetry's sums are taken over per-vertex values
    gathered in vertex order, and every rank must pass the same
    ``schedule_id``.

    ``zero1=True`` (``mode="edst"``, striped engine) is the ZeRO-1 step:
    the gradients are ``tree_reduce_scatter``'d onto owner stripes,
    :class:`repro_torch.optim.sharded.ShardedAdamW` updates the params in
    the scattered domain (the clip norm a sum of per-vertex partial
    sums), and only the updated params are ``tree_allgather``'d back.
    ``opt_state`` is then a :class:`ShardedOptState` of the rank's own
    vertices (build it with ``ShardedAdamW(opt).init_for(params,
    spec_or_runtime, n, fabric=...)``, the fabric of the rank's block;
    stacked, all n).

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
    bytes, per entry with a fault runtime; 0 for ``psum_dp`` and
    ``gspmd``, whose ``sync_dev`` is 0 too: nothing is synchronized by
    hand); for zero1 also ``ag_replicas_equal``: whether every vertex
    row of the allgathered params equals vertex 0's, bit for bit (over
    ranks vertex 0's row is broadcast and every rank's answer agreed).
    Over ranks the per-row checksums and partial sums are gathered in
    vertex order, so ``sync_dev`` is the stacked step's, bit for bit."""
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
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    loss_of = loss if loss is not None else api.loss_fn
    # over a process group each rank holds a block of the vertices (under
    # gspmd: an even share of the batch); stacked, one rank holds them all
    pg = group is not None or world_size() > 1
    world = dist.get_world_size(group) if pg else 1
    rank = dist.get_rank(group) if pg else 0
    if mode == "gspmd":
        counts = [1] * world
        lo, hi = 0, 1
    else:
        blocks = vertex_blocks(n, world)
        counts = [b - a for a, b in blocks]
        lo, hi = blocks[rank]
    # gradient rows: one a local vertex, or this rank's batch share's one
    # under gspmd
    rows_n = hi - lo
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

                def z_sl(vec, sid, fabric):
                    return owner_stripes(vec, spec, fabric=fabric)

                def z_ag(owned, sid, shape, fabric):
                    return tree_allgather(owned, spec, fabric, shape)
    fabrics: dict = {}
    decay: dict = {}

    def fabric_on(dev):
        fabric = fabrics.get(dev)
        if fabric is None:
            fabric = fabrics[dev] = ProcessGroupFabric(n, dev, group) if pg \
                else StackedFabric(n, dev)
        return fabric

    def mean_over_all(vals):
        """The mean of one value a local row over every rank's rows,
        gathered in vertex order and reduced as one tensor, so that its
        bits do not depend on how the rows are spread over the ranks."""
        t = torch.stack(vals)
        return (gather_blocks(t, counts, group) if pg else t).mean()

    def wire_gauge(nbytes: int, itemsize: int, sid: int) -> float:
        if fault_runtime is not None:
            return _entry_wire_table(fault_runtime.entries, nbytes,
                                     itemsize)[sid]
        if spec is not None:
            return float(sum(wave_wire_bytes(spec, nbytes, itemsize)))
        return 0.0

    def local_grads(params, batch):
        """``(rows, P)`` gradients (a row a local vertex: the mean
        gradient of its microbatches; under gspmd one row, the gradient of
        this rank's share of the batch, the whole batch's when stacked),
        the loss and the loss's metrics, each the mean over all vertices
        (ranks, under gspmd) of its mean over the microbatches."""
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        size = sum(p.numel() for p in leaves)
        grads = torch.empty((rows_n, size), dtype=leaves[0].dtype,
                            device=leaves[0].device)
        losses, auxs = [], []
        parts = [batch] if mode == "gspmd" else _split_batch(batch, n)
        for v, part in enumerate(parts[lo:hi]):
            row = grads[v]
            mlosses, maux = [], []
            for i, mb in enumerate(_split_batch(part, grad_accum,
                                                "microbatches")):
                lv, aux = loss_of(params, mb)
                off = 0
                for g in torch.autograd.grad(lv, leaves):
                    dst = row[off:off + g.numel()]
                    if i:
                        dst.add_(g.reshape(-1))
                    else:
                        dst.copy_(g.reshape(-1))
                    off += g.numel()
                mlosses.append(lv.detach())
                maux.append({k: a.detach() for k, a in aux.items()})
            if grad_accum > 1:
                row.div_(grad_accum)
            losses.append(sum(mlosses) / grad_accum)
            auxs.append(_mean_aux(maux))
        return grads, mean_over_all(losses), {
            k: mean_over_all([a[k] for a in auxs]) for k in auxs[0]}

    def sync(g, sid):
        """(rows, P) per-vertex gradients -> (P,) mean gradient, and the
        telemetry of the sync."""
        tel = {}
        if mode == "gspmd" or n == 1:
            out = g[0]
        elif mode == "psum_dp":
            # the local rows' sum, then one all_reduce over the ranks
            out = fabric_on(g.device).psum(g)[0] / n
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
                    fabric.gather(payload_checksum(rows)))),
                    "sync_wire_bytes": wire_gauge(
                        size * rows.element_size(), rows.element_size(),
                        sid)}
            out = rows[0] / n
        if telemetry:
            tel.setdefault("sync_dev", 0.0)
            tel.setdefault("sync_wire_bytes", 0.0)
            # a sum of squares, as the reference's tree norm (the CPU's f32
            # norm() of a long vector reads up to 5e-5 low)
            tel["sync_grad_norm"] = float(torch.sqrt((out.float() ** 2).sum()))
            tel["sync_schedule_id"] = sid
        return out, tel

    def dense_step(params, opt_state, batch, sid):
        grads, loss, aux = local_grads(params, batch)
        flat, tel = sync(grads, sid)
        del grads
        new_params, new_state, om = opt.apply(
            _detach(params), _unflatten(flat, params), opt_state)
        return new_params, new_state, {"loss": loss, **om, **aux, **tel}

    sopt = ShardedAdamW(opt)

    def replicas_equal(rows, fabric) -> bool:
        """Whether every local row equals vertex 0's bit for bit, on every
        rank: vertex 0's row is broadcast from its rank, and the ranks'
        answers are agreed by one ``all_reduce`` MIN."""
        ref = rows[0] if fabric.owns(0) else torch.empty_like(rows[0])
        ref = fabric.broadcast(ref, 0)
        return fabric.all_true(all(torch.equal(r, ref) for r in rows))

    def zero1_step(params, opt_state, batch, sid):
        grads, loss, aux = local_grads(params, batch)
        fabric = fabric_on(grads.device)
        owned_g = z_rs(grads, sid, fabric) / n
        tel = {}
        if telemetry:
            tel["sync_dev"] = float(rs_conservation_gap(
                grads.float().sum(1) / n, owned_g, fabric))
            tel["sync_wire_bytes"] = wire_gauge(
                grads[0].numel() * grads.element_size(),
                grads.element_size(), sid)
        del grads
        flat_p = _flat(params).float()
        dev = flat_p.device
        if dev not in decay:
            decay[dev] = decay_mask(params, opt.weight_decay)
        owned_p = z_sl(flat_p, sid, fabric)
        owned_d = z_sl(decay[dev], sid, fabric)
        step = opt_state.step + 1
        # the n per-vertex partial sums in vertex order, summed as one
        # tensor: the stacked step's norm, bit for bit
        gnorm = torch.sqrt(fabric.gather(sopt.partial_sumsq(owned_g)).sum())
        new_op, mu, nu, lr = sopt.update_stripes(
            owned_p, owned_g, owned_d, opt_state.mu, opt_state.nu, step,
            gnorm)
        del owned_g, owned_p, owned_d
        rows = z_ag(new_op, sid, flat_p.shape, fabric)
        del new_op
        if telemetry:
            tel["ag_replicas_equal"] = replicas_equal(rows, fabric)
            tel["sync_grad_norm"] = float(gnorm)
            tel["sync_schedule_id"] = sid
        new_flat = rows[0].clone()
        del rows
        new_params = _unflatten(new_flat, params)
        return new_params, ShardedOptState(step, mu, nu), {
            "loss": loss, "grad_norm": gnorm, "lr": lr, **tel, **aux}

    body = zero1_step if zero1 else dense_step
    if mode == "gspmd" and pg:
        body = _gspmd_body(loss_of, opt, grad_accum, telemetry, fsdp, group)

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


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a tree of dicts, tuples (named ones
    too) and lists; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _full(x):
    """A DTensor's whole value as a plain tensor; a plain one as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def full_values(tree):
    """``tree`` with every DTensor replaced by its whole value (a
    collective: every rank of its mesh calls it); the rest as it is."""
    return _map_tensors(_full, tree)


def _gspmd_body(loss_of, opt, grad_accum: int, telemetry: bool,
                fsdp: bool, group):
    """The ``gspmd`` step over the ranks of ``group`` on DTensors (see
    :func:`make_train_step`): ``body(params, opt_state, batch, sid)``."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from .sharding import gather_fsdp, placements, spec_for
    meshes: dict = {}

    def group_mesh(device):
        """Plain parameters' mesh: the group's ranks on one data axis."""
        mesh = meshes.get(device.type)
        if mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            mesh = meshes[device.type] = DeviceMesh.from_group(
                group or dist.group.WORLD, device.type,
                mesh_dim_names=("data",))
        return mesh

    def microbatches(batch, mesh):
        """Each entry's rows split over the data axes (as ``spec_for``
        places a ``batch`` dim), then this rank's rows into
        ``grad_accum`` microbatches."""
        out = [{} for _ in range(grad_accum)]
        for k, v in batch.items():
            axes = ("batch",) + (None,) * (v.dim() - 1)
            pl = placements(spec_for(axes, v.shape, mesh, fsdp=False), mesh)
            local = distribute_tensor(v, mesh, pl,
                                      src_data_rank=None).to_local()
            parts = _split_batch({k: local}, grad_accum, "microbatches")
            for i, part in enumerate(parts):
                out[i][k] = DTensor.from_local(part[k], mesh, pl)
        return out

    def body(params, opt_state, batch, sid):
        leaves = tree_leaves(params)
        plain = not isinstance(leaves[0], DTensor)
        if plain:
            mesh = group_mesh(leaves[0].device)
            rep = [Replicate()]

            def wrap(t):
                return DTensor.from_local(t, mesh, rep)
            params = _map_tensors(wrap, params)
            opt_state = _map_tensors(wrap, opt_state)
            leaves = tree_leaves(params)
        mesh = leaves[0].device_mesh
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        grads, losses, auxs = None, [], []
        with implicit_replication():
            for mb in microbatches(batch, mesh):
                used = _unflatten_leaves(leaves, params)
                if fsdp:
                    used = gather_fsdp(used)
                lv, aux = loss_of(used, mb)
                gs = torch.autograd.grad(lv, leaves)
                grads = list(gs) if grads is None else \
                    [a + b for a, b in zip(grads, gs)]
                losses.append(_full(lv.detach()))
                auxs.append({k: _full(a.detach()) for k, a in aux.items()})
            grads = [g.redistribute(mesh, p.placements)
                     for g, p in zip(grads, leaves)]
            if grad_accum > 1:
                grads = [g / grad_accum for g in grads]
            new_params, new_state, om = opt.apply(
                _unflatten_leaves([p.detach() for p in leaves], params),
                _unflatten_leaves(grads, params), opt_state)
        metrics = {"loss": sum(losses) / grad_accum,
                   **{k: _full(v) for k, v in om.items()},
                   **_mean_aux(auxs)}
        if telemetry:
            metrics.update(sync_dev=0.0, sync_wire_bytes=0.0,
                           sync_grad_norm=float(metrics["grad_norm"]),
                           sync_schedule_id=sid)
        if plain:
            new_params = full_values(new_params)
            new_state = full_values(new_state)
        return new_params, new_state, metrics

    return body


def _unflatten_leaves(leaves: list, like):
    """The tree of ``like`` with ``leaves`` in sorted-key order."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)
    return fill(like)
