"""Elastic EDST runtime: precompiled failure-class schedules (the reference's
``repro/dist/fault.py``).

``repro_torch.core.fault`` knows *what* to do when links die (keep the
surviving edge-disjoint trees, repack the residual fabric with
Roskind-Tarjan, re-stripe chunks around stragglers).  This module turns
it into runnable behaviour on a fabric (the stacked one, or a
process-group rank's block of vertices):

  * :class:`FaultAwareAllreduce` compiles, up front, one wave program per
    *failure class*: the healthy k-tree schedule, one degraded (k-1)-tree
    schedule per tree (valid for ANY single-link failure inside that
    tree, since edge-disjointness puts the dead link in exactly one
    tree), and one rebuilt-EDST schedule per tree (Roskind-Tarjan
    repacking of the fabric minus that whole tree).
  * :meth:`FaultAwareAllreduce.make_allreduce` prebuilds one callable per
    entry, indexed by an integer schedule id.  The reference selects the
    entry with ``jax.lax.switch`` over a traced id so a flip never
    retraces; eager PyTorch has no trace, and its form of the promise is
    that a flip builds no spec and binds no table: once every entry has
    run, a flip creates no new ``striped_tables`` binding and no new
    fabric index tensor.  ``lax.switch`` clamps a bad id and a Python
    index wraps a negative one, so every id passes through
    :func:`repro_torch.analysis.verify.check_schedule_id` and a bad one
    raises; the reference's ``debug`` NaN poison, a signal for a clamp
    it cannot raise on inside a traced program, has no reason to exist
    here.
  * Chunk striping is weighted by
    :func:`repro_torch.core.fault.rebalance_chunks` (inverse critical-path
    cost), so when a tree dies the gradient re-stripes over the survivors.

Failures outside the precompiled classes (several trees hit, node loss)
go through :meth:`FaultAwareAllreduce.with_rebuild`, which repacks the
actual residual fabric into a NEW runtime.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..analysis.verify import check_schedule_id, verify_spec
from ..core.collectives import (AllreduceSchedule, CostModel,
                                FusedAllreduceSpec, PipelinedAllreduceSpec,
                                StripedCollectiveSpec, allreduce_schedule,
                                empty_pipelined_spec, empty_striped_spec,
                                owner_element_map,
                                pipelined_spec_from_schedule,
                                simulate_allreduce,
                                striped_spec_from_schedule, striped_tables)
from ..core.edst_rt import max_edsts
from ..core.fault import FailureEvent, rebalance_chunks
from ..core.graph import Graph, canon
from ..telemetry import metrics as _metrics
from .fabric import StackedFabric
from .striped import (owner_stripes, striped_allreduce, tree_allgather,
                      tree_reduce_scatter)
from .tree_allreduce import fused_tree_allreduce, pipelined_tree_allreduce


class NoScheduleError(RuntimeError):
    """No precompiled schedule survives the failure; a dynamic rebuild
    (``with_rebuild``) or an elastic rescale
    (``repro_torch.launch.elastic``) is required before the collective
    can resume."""


# ---------------------------------------------------------------------------
# schedule entries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScheduleEntry:
    """One precompiled failure-class program.  ``spec`` carries the
    runtime's engine form: the pipelined wave program by default, or the
    striped reduce-scatter/allgather program for ``engine="striped"``."""
    name: str        # "full" | "degraded/tree<j>" | "rebuilt/tree<j>"
    spec: PipelinedAllreduceSpec | StripedCollectiveSpec
    fractions: tuple               # per-tree chunk fractions, sum 1
    sched: AllreduceSchedule | None  # core schedule (cost model / simulator)

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def depth(self) -> int:
        return self.spec.depth

    def uses_link(self, dead_links: set) -> bool:
        if self.sched is None:
            return False
        return any(set(ts.tree) & dead_links for ts in self.sched.trees)


def striped_tree_allreduce(x, spec, fabric, fractions, quantize: bool = False,
                           segments="auto", codec=None):
    """Weighted-stripe k-tree allreduce over the stacked vertices of ``x``:
    contiguous slice j of each flattened row (``chunk_sizes(size,
    fractions)[j]`` elements) travels tree j.  Dispatches on the spec
    form (pipelined, striped, fused); ``codec`` overrides the device's
    codec policy for ``quantize``."""
    if spec.k == 0:
        return x
    if isinstance(spec, StripedCollectiveSpec):
        return striped_allreduce(x, spec, fabric, quantize,
                                 fractions=fractions, codec=codec)
    if isinstance(spec, FusedAllreduceSpec):
        return fused_tree_allreduce(x, spec, fabric, quantize,
                                    fractions=fractions, codec=codec)
    return pipelined_tree_allreduce(x, spec, fabric, quantize,
                                    segments=segments, fractions=fractions,
                                    codec=codec)


def _pad_stripes(owned, kmax: int, smax: int):
    """Zero-pad a ``(rows, k, s)`` stripe stack to the runtime-wide
    ``(rows, kmax, smax)`` so every entry returns one common shape."""
    _, k, s = owned.shape
    if k == kmax and s == smax:
        return owned
    return F.pad(owned, (0, smax - s, 0, kmax - k))


def _entry(name: str, n: int, trees, axes,
           engine: str = "pipelined") -> ScheduleEntry:
    trees = [frozenset(canon(*e) for e in t) for t in trees]
    empty = (empty_striped_spec if engine == "striped"
             else empty_pipelined_spec)
    compile_spec = (striped_spec_from_schedule if engine == "striped"
                    else pipelined_spec_from_schedule)
    if not trees:
        return ScheduleEntry(name, empty(n, axes), (), None)
    sched = allreduce_schedule(n, trees)
    fracs = tuple(rebalance_chunks(sched, {}))
    return ScheduleEntry(name, compile_spec(sched, axes), fracs, sched)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

@dataclass
class FaultAwareAllreduce:
    """Precompiled healthy/degraded/rebuilt EDST allreduce programs with a
    schedule id selecting among them (see the module docstring).

    Entry layout (k = healthy tree count):
      id 0          -- full k-tree schedule;
      id 1 .. k     -- degraded: tree j-1 lost, chunks re-striped over the
                       k-1 survivors;
      id k+1 .. 2k  -- rebuilt: max EDST repacking of the fabric minus all
                       of tree j-k-1's links (>= the degraded k-1, often k).
    """
    graph: Graph
    axes: tuple
    entries: tuple                 # tuple[ScheduleEntry]
    active: int = 0
    history: list = field(default_factory=list)
    engine: str = "pipelined"      # compiled form of every entry's spec
    # reshard_owned's plans (index tensors on the state's device), keyed
    # (from_id, to_id, size, device, block); shared across on_failure
    # replaces so a flip builds none
    _reshard_cache: dict = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, graph: Graph, trees, axis_names,
              engine: str = "pipelined") -> "FaultAwareAllreduce":
        """Every entry's waves are assembled by greedy list scheduling."""
        if engine not in ("pipelined", "striped"):
            raise ValueError(
                f"engine {engine!r} not in ('pipelined', 'striped')")
        trees = [frozenset(canon(*e) for e in t) for t in trees]
        axes = tuple(axis_names)
        k = len(trees)
        entries = [_entry("full", graph.n, trees, axes, engine)]
        for j in range(k):
            keep = trees[:j] + trees[j + 1:]
            entries.append(_entry(f"degraded/tree{j}", graph.n, keep, axes,
                                  engine))
        for j in range(k):
            # class rebuild: drop ALL of tree j's links, so the repacked
            # trees avoid any single link failure attributable to tree j
            residual = graph.without_edges(trees[j])
            rebuilt = max_edsts(residual)[0] if residual.is_connected() else []
            if not rebuilt:  # k=1 fabrics: nothing to repack from
                rebuilt = trees[:j] + trees[j + 1:]
            entries.append(_entry(f"rebuilt/tree{j}", graph.n, rebuilt, axes,
                                  engine))
        return cls(graph, axes, tuple(entries), engine=engine)

    @property
    def k(self) -> int:
        return self.entries[0].k

    @property
    def entry(self) -> ScheduleEntry:
        return self.entries[self.active]

    def gate(self, schedule_id) -> int:
        """``schedule_id`` as a Python int inside ``[0, len(entries))``,
        or a ``ValueError`` naming the ``sid-out-of-range`` violation."""
        sid = operator.index(schedule_id)
        bad = check_schedule_id(len(self.entries), sid)
        if bad is not None:
            raise ValueError(str(bad))
        return sid

    # -- failure handling ---------------------------------------------------

    def valid_ids(self, event: FailureEvent) -> list:
        """Precompiled schedules whose trees avoid every dead link."""
        dead = event.dead_links(self.graph)
        return [i for i, e in enumerate(self.entries)
                if e.k > 0 and not e.uses_link(dead)]

    def on_failure(self, event: FailureEvent,
                   prefer: str = "max_k") -> "FaultAwareAllreduce":
        """Select the recovery schedule for ``event``: an id flip, never a
        rebuild.  ``prefer="max_k"`` picks the surviving program with the
        most trees (rebuilt classes usually restore k);
        ``prefer="degraded"`` picks the lowest valid id (the plain
        surviving-tree program).  Raises :class:`NoScheduleError` when no
        precompiled program survives (multi-tree wipeout, node loss)."""
        if event.nodes:
            raise NoScheduleError(
                "node loss changes the fabric; rescale via "
                "repro_torch.launch.elastic")
        valid = self.valid_ids(event)
        if not valid:
            raise NoScheduleError(
                "no precompiled schedule survives; use with_rebuild(event)")
        if prefer == "degraded":
            pick = valid[0]
        else:
            pick = max(valid, key=lambda i: (self.entries[i].k,
                                             -self.entries[i].depth, -i))
        hist = self.history + [(self.entries[pick].name, self.entries[pick].k)]
        _metrics.counter("edst_schedule_flips_total",
                         "precompiled schedule-id flips on failure"
                         ).inc(prefer=prefer)
        return replace(self, active=pick, history=hist)

    def with_rebuild(self, event: FailureEvent) -> "FaultAwareAllreduce":
        """Dynamic fallback for failures outside the precompiled classes:
        Roskind-Tarjan repack of the ACTUAL residual fabric into a fresh
        runtime."""
        if event.nodes:
            raise NoScheduleError(
                "node loss changes the fabric; rescale via "
                "repro_torch.launch.elastic")
        dead = event.dead_links(self.graph)
        residual = self.graph.without_edges(dead)
        if not residual.is_connected():
            raise NoScheduleError("residual fabric disconnected")
        trees, _ = max_edsts(residual)
        if not trees:
            raise NoScheduleError("residual fabric packs no spanning tree")
        rebuilt = FaultAwareAllreduce.build(residual, trees, self.axes,
                                           engine=self.engine)
        rebuilt.history = self.history + [("with_rebuild", len(trees))]
        _metrics.counter("edst_rebuilds_total",
                         "dynamic Roskind-Tarjan schedule rebuilds").inc()
        return rebuilt

    # -- execution ----------------------------------------------------------

    def make_allreduce(self, quantize: bool = False, segments="auto",
                       codec=None):
        """``allreduce(x, schedule_id, fabric)``: the prebuilt program of
        entry ``schedule_id`` on the stacked vertices of ``x``
        (``(n, ...)``); every row of the result holds the sum.
        ``segments`` streams the pipelined programs' chunks in that many
        segments (``"auto"``: see ``auto_segments``); ``codec`` overrides
        the device's codec policy for ``quantize``."""
        def branch(e: ScheduleEntry):
            if e.k == 0:
                return lambda v, fabric: v  # unreachable via on_failure
            return lambda v, fabric: striped_tree_allreduce(
                v, e.spec, fabric, e.fractions, quantize, segments, codec)

        branches = tuple(branch(e) for e in self.entries)

        def allreduce(x, schedule_id, fabric):
            return branches[self.gate(schedule_id)](x, fabric)

        return allreduce

    # -- ZeRO-1: scattered-domain primitives --------------------------------

    def _require_striped(self):
        if self.engine != "striped":
            raise ValueError(
                "zero1 needs the reduce-scatter/allgather split: build the "
                "runtime with engine='striped'")

    def zero1_geometry(self, size: int) -> tuple:
        """(kmax, smax): the padded stripe-stack shape covering every
        precompiled failure class for a ``size``-element payload, the
        shape of the zero1 optimizer state."""
        self._require_striped()
        kmax = max(e.k for e in self.entries)
        smax = max(striped_tables(e.spec, size, e.fractions).smax
                   for e in self.entries if e.k > 0)
        return kmax, smax

    def zero1_element_map(self, size: int,
                          entry_id: int | None = None) -> np.ndarray:
        """Element ownership of one failure class, padded to the
        runtime-wide ``(n, kmax, smax)`` (``-1`` = padding): row ``v``
        names the flat payload indices vertex ``v`` owns under that
        schedule, the geometry sharded checkpoints save beside the
        moment stripes."""
        kmax, smax = self.zero1_geometry(size)
        e = self.entries[self.active if entry_id is None
                         else self.gate(entry_id)]
        out = np.full((self.graph.n, kmax, smax), -1, np.int64)
        if e.k > 0:
            m = owner_element_map(e.spec, size, e.fractions)
            out[:, :m.shape[1], :m.shape[2]] = m
        return out

    def _stripe_runs(self, size: int, entry_id: int) -> list:
        """Entry ``entry_id``'s ownership as runs: ``(v, j, flat start,
        width)`` for every non-empty owner stripe.  A stripe owns one
        contiguous run of the flat payload (``owner_element_map``'s rows
        are ``start + arange(width)``)."""
        e = self.entries[entry_id]
        if e.k == 0:
            return []
        t = striped_tables(e.spec, size, e.fractions)
        chunk = np.concatenate([[0], np.cumsum(t.sizes)])
        runs = []
        for j in range(e.k):
            for v in range(self.graph.n):
                off = int(t.own_off[j, v])
                width = min(int(t.own_len[j, v]), int(t.sizes[j]) - off)
                if width > 0:
                    runs.append((v, j, int(chunk[j]) + off, width))
        return runs

    def owned_permutation(self, from_id: int, to_id: int,
                          size: int) -> np.ndarray:
        """The stripe permutation between two failure classes:
        ``perm[v, j, i]`` is the linear index into the flattened
        ``(n, kmax, smax)`` ``from_id``-layout state of the element that
        lands at ``[v, j, i]`` under ``to_id`` (``-1`` = padding).  Built
        from the two entries' stripe runs (the element maps inverted run
        against run), so its cost is one write per element."""
        from_id, to_id = self.gate(from_id), self.gate(to_id)
        kmax, smax = self.zero1_geometry(size)
        src = sorted(self._stripe_runs(size, from_id), key=lambda r: r[2])
        starts = np.array([r[2] for r in src], np.int64)
        perm = np.full((self.graph.n, kmax, smax), -1, np.int64)
        for v, j, start, width in self._stripe_runs(size, to_id):
            end = start + width
            i = max(int(np.searchsorted(starts, start, "right")) - 1, 0)
            while i < len(src) and src[i][2] < end:
                sv, sj, s0, sw = src[i]
                lo, hi = max(start, s0), min(end, s0 + sw)
                if lo < hi:
                    base = (sv * kmax + sj) * smax + (lo - s0)
                    perm[v, j, lo - start:hi - start] = np.arange(
                        base, base + hi - lo, dtype=np.int64)
                i += 1
        return perm

    def reshard_owned(self, arr, from_id: int, to_id: int, size: int,
                      fabric=None):
        """Re-shard owner-stripe state (zero1 ``mu`` / ``nu``) from one
        failure class's ownership to another's, exact (a permutation of
        the same elements), into a new tensor.  Runs outside the train
        step, which re-stripes the collectives itself.

        ``arr`` holds the rows of ``fabric``'s local vertices: the whole
        ``(n, kmax, smax)`` state without a fabric or on the stacked one,
        a process-group rank's own block on a
        :class:`~repro_torch.dist.fabric.ProcessGroupFabric`.  The
        elements that stay on the rank are one local gather; those that
        change rank travel in one ``batch_isend_irecv`` (a message a pair
        of ranks), so no rank holds more than its old and new rows and
        what it sends.  The plan lives on ``arr``'s device, built once per
        (from_id, to_id, size, device) and block: repeated flips, and the
        flip back, build none."""
        self._require_striped()
        from_id, to_id = self.gate(from_id), self.gate(to_id)
        if fabric is None:
            fabric = StackedFabric(self.graph.n, arr.device)
        if arr.shape[0] != fabric.rows:
            raise ValueError(f"expected {fabric.rows} owner rows, got "
                             f"{tuple(arr.shape)}")
        key = (from_id, to_id, int(size), arr.device, fabric.lo, fabric.hi,
               fabric.world)
        plan = self._reshard_cache.get(key)
        if plan is None:
            plan = self._reshard_cache[key] = self._block_plan(
                from_id, to_id, size, fabric, arr.device)
        local, pad, sends, recvs = plan
        flat = arr.reshape(-1)
        out = flat.index_select(0, local)
        stripes = out.view(-1, arr.shape[-1])
        for row, width in pad:
            stripes[row, width:] = 0
        ops, bufs = [], []
        for peer, idx in sends:
            ops.append(dist.P2POp(dist.isend, flat.index_select(0, idx),
                                  peer, fabric.group))
        for peer, dst in recvs:
            bufs.append((dst, arr.new_empty(dst.numel())))
            ops.append(dist.P2POp(dist.irecv, bufs[-1][1], peer,
                                  fabric.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        del ops
        for dst, buf in bufs:
            out[dst] = buf
        return out.reshape(arr.shape)

    def _block_plan(self, from_id, to_id, size, fabric, device):
        """``(local, pad, sends, recvs)`` of a block's reshard, built on
        the host and moved to ``device`` as index tensors: ``local``
        gathers every new-layout element of the block's rows from its old
        rows (an element that arrives from another rank, or is padding,
        reads slot 0 and is overwritten); ``pad`` ``[(stripe row, width)]``
        for every ``(vertex, tree)`` stripe row of the block whose
        new-layout stripe is narrower than ``smax`` (its tail is padding);
        ``sends`` ``[(peer's global rank, old slots)]`` and ``recvs``
        ``[(peer's global rank, new slots)]`` in the order of the new
        layout's linear index, one entry a peer, the same order on both
        ends."""
        kmax, smax = self.zero1_geometry(size)
        per = kmax * smax
        perm = self.owned_permutation(from_id, to_id, size).reshape(
            self.graph.n, per)
        lo, hi = fabric.lo * per, fabric.hi * per
        dt = np.int32 if fabric.rows * per < 2 ** 31 - 1 else np.int64

        def peer(r):
            return dist.get_global_rank(fabric.group, r) \
                if fabric.group is not None else r

        def index(a):
            return torch.from_numpy(a.astype(dt)).to(device)

        # old global slots; vertex v's rows are slots [v * per, (v+1) * per)
        mine = perm[fabric.lo:fabric.hi].reshape(-1)
        sends, recvs = [], []
        for r, (rlo, rhi) in enumerate(fabric.blocks):
            if r == fabric.rank:
                continue
            from_r = np.flatnonzero((mine >= rlo * per) & (mine < rhi * per))
            if from_r.size:
                recvs.append((peer(r), index(from_r)))
            theirs = perm[rlo:rhi].reshape(-1)
            take = theirs[(theirs >= lo) & (theirs < hi)]
            if take.size:
                sends.append((peer(r), index(take - lo)))
        local = np.where((mine >= lo) & (mine < hi), mine - lo, 0)
        widths = np.zeros((fabric.rows, kmax), np.int64)
        for v, j, _, width in self._stripe_runs(size, to_id):
            if fabric.owns(v):
                widths[v - fabric.lo, j] = width
        pad = tuple((row, int(w)) for row, w in enumerate(widths.reshape(-1))
                    if w < smax)
        return index(local), pad, tuple(sends), tuple(recvs)

    def make_zero1_sync(self, quantize: bool = False, codec=None):
        """The three scattered-domain primitives of the zero1 step, each a
        table of prebuilt callables indexed by the schedule id:

          * ``rs(grads, sid, fabric)`` -- reduce-scatter of the ``(rows,
            P)`` gradients of the fabric's local vertices -> ``(rows,
            kmax, smax)`` summed owner stripes
            (the codec policy applies to these wires);
          * ``slices(vec, sid, fabric=None)`` -- communication-free
            owner-stripe cut of ONE replicated ``(P,)`` vector (params,
            decay mask) -> ``(rows, kmax, smax)``, the fabric's local
            vertices' (all n without one);
          * ``ag(owned, sid, shape, fabric)`` -- allgather of the updated
            params -> ``(rows, *shape)``.  Always full precision: params
            derived from optimizer state must not accumulate wire
            quantization error across steps.

        Every entry pads to the runtime-wide geometry, so one state shape
        serves every id; ``k=0`` entries (k=1 fabrics with nothing to
        repack from, unreachable via ``on_failure``) return zeros."""
        self._require_striped()

        def rs_branch(e):
            def run(g, fabric):
                kmax, smax = self.zero1_geometry(g[0].numel())
                if e.k == 0:
                    return g.new_zeros((g.shape[0], kmax, smax))
                return _pad_stripes(
                    tree_reduce_scatter(g, e.spec, fabric, e.fractions,
                                        quantize, codec), kmax, smax)
            return run

        def slices_branch(e):
            def run(vec, fabric):
                kmax, smax = self.zero1_geometry(vec.numel())
                if e.k == 0:
                    rows = self.graph.n if fabric is None else fabric.rows
                    return vec.new_zeros((rows, kmax, smax))
                return _pad_stripes(owner_stripes(vec, e.spec, e.fractions,
                                                  fabric), kmax, smax)
            return run

        def ag_branch(e):
            def run(owned, shape, fabric):
                if e.k == 0:
                    return owned.new_zeros((owned.shape[0], *shape))
                size = math.prod(int(d) for d in shape)
                smax_e = striped_tables(e.spec, size, e.fractions).smax
                return tree_allgather(owned[:, :e.spec.k, :smax_e], e.spec,
                                      fabric, shape, e.fractions)
            return run

        rs_t = tuple(rs_branch(e) for e in self.entries)
        sl_t = tuple(slices_branch(e) for e in self.entries)
        ag_t = tuple(ag_branch(e) for e in self.entries)

        def rs(grads, sid, fabric):
            return rs_t[self.gate(sid)](grads, fabric)

        def slices(vec, sid, fabric=None):
            return sl_t[self.gate(sid)](vec, fabric)

        def ag(owned, sid, shape, fabric):
            return ag_t[self.gate(sid)](owned, shape, fabric)

        return rs, slices, ag

    # -- reporting ----------------------------------------------------------

    def effective_bandwidth(self, nbytes: float, entry_id: int | None = None,
                            cost_model: CostModel | None = None) -> float:
        """bytes/s the schedule sustains for an ``nbytes`` allreduce (by
        the ``CostModel``, whose rows are the reference's)."""
        e = self.entries[self.active if entry_id is None
                         else self.gate(entry_id)]
        if e.sched is None:
            return 0.0
        cm = cost_model or CostModel()
        return nbytes / cm.edst_tree_allreduce(nbytes, e.sched)

    def verify_entry(self, entry_id: int, d: int | None = None,
                     seed: int = 0, static: bool = False) -> bool:
        """Correctness of one precompiled program.  ``static=True`` runs
        the O(messages) static verifier (:mod:`repro_torch.analysis.verify`)
        on the entry's compiled spec -- no simulation, the mode for large
        fabrics; the default replays the schedule through the numpy
        packet simulator."""
        e = self.entries[self.gate(entry_id)]
        if e.sched is None:
            return False
        if static:
            return verify_spec(e.spec, level="full").ok
        d = d or 8 * e.k
        vals = np.random.RandomState(seed).randn(self.graph.n, d)
        return simulate_allreduce(e.sched, vals).ok

    def report(self, nbytes: float = 64 << 20,
               cost_model: CostModel | None = None) -> dict:
        """One row per precompiled program: tree count, schedule depth,
        modelled allreduce cost and effective bandwidth."""
        cm = cost_model or CostModel()
        rows = []
        for i, e in enumerate(self.entries):
            # k=0 entries carry no cost: None/0, not inf (invalid JSON)
            cost = (cm.edst_tree_allreduce(nbytes, e.sched)
                    if e.sched is not None else None)
            rows.append({"id": i, "name": e.name, "k": e.k,
                         "depth": e.depth,
                         "cost_ms": None if cost is None else cost * 1e3,
                         "gbps": 0.0 if cost is None else nbytes / cost / 1e9})
        return {"n": self.graph.n, "k": self.k, "active": self.active,
                "nbytes": nbytes, "entries": rows}
