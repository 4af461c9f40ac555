"""Fault *detection* for the EDST collective engines (the reference's
``repro/dist/health.py``), on a fabric: the stacked one, or the ranks of
a ``torch.distributed`` group, each holding a block of the vertices.

:mod:`repro_torch.dist.fault` recovers from failures it is told about --
a ``FailureEvent`` flips the schedule id.  This module is the sensing
half of the loop (detect -> classify -> escalate -> recover; the
escalation ladder lives in :mod:`repro_torch.dist.recovery`):

  * **link heartbeat probes** -- every directed link any compiled wave
    program uses (read from the spec's own routing tables) is echoed
    with a one-element token through the fabric's ``ppermute``.  The
    sender ships ``rank + 1``; the receiver compares it with the
    statically known sender (``ppermute`` zero-fills vertices nobody
    sent to, so a dead wire reads 0 and never aliases a healthy token).
    Each wave's results land in an ``(L,)`` link-OK bitmap, one slot a
    link: the reference's ``psum`` over the devices is one
    ``index_add_`` over the local vertex rows (each rank reads the links
    that end at its own vertices) and, over ranks, one ``all_reduce``,
    after which every rank holds the global bitmap.
  * **payload checksums** -- after a gradient allreduce every vertex row
    must hold bit-identical sums; :func:`replication_divergence` is the
    spread of a per-row (sum, sum-of-squares) checksum over the rows.
    The striped / ZeRO-1 engines scatter instead of replicate, so their
    check is conservation
    (:func:`repro_torch.dist.striped.rs_conservation_gap`).
  * **straggler detection** -- wall-clock step times against a rolling
    median (:class:`StragglerDetector`).

Over ranks every input a recovery decision reads is agreed before the
decision, so each rank's :class:`repro_torch.dist.recovery.RecoveryController`
takes the same one at the same tick: :meth:`HealthMonitor.check` reduces
the probe's failures and the step time in one ``all_reduce`` MAX (the
slowest rank's step time), :meth:`HealthMonitor.clock` is the latest
rank's clock reading, and the checksum spread is already global (the step
gathers the per-row checksums in vertex order).

:class:`HealthMonitor` bundles the three behind one ``check(step, ...)``
returning a :class:`HealthReport`, whose ``failed_edges()`` /
``node_suspects()`` :class:`repro_torch.dist.recovery.RecoveryController`
classifies into ``FailureEvent``s.  The probe takes an ``(L,)``
``fault_mask`` ANDed onto the receive side, where a test injects wire
faults; on a real fabric it stays all ones.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.verify import engine_of
from ..core.graph import canon
from ..telemetry import metrics as _metrics
from .fabric import StackedFabric, _BlockFabric


# ---------------------------------------------------------------------------
# link extraction: the probe plan is compiled from the routing tables
# ---------------------------------------------------------------------------

def program_links(spec) -> tuple:
    """Sorted directed ``(src, dst)`` links the compiled wave program
    moves payload over, for any engine's spec form.  Read from the same
    routing tables the executors run, so the probe set is exactly the
    fabric surface the collective depends on."""
    eng = engine_of(spec)
    links = set()
    if eng in ("pipelined", "striped"):
        for wv in spec.waves:
            links.update((int(s), int(d)) for s, d in wv.perm)
    elif eng == "fused":
        for rnd in tuple(spec.reduce_rounds) + tuple(spec.bcast_rounds):
            links.update((int(s), int(d)) for s, d in rnd.perm)
    else:  # per_tree
        for tp in spec.trees:
            for perm in tuple(tp.reduce_rounds) + tuple(tp.bcast_rounds):
                links.update((int(s), int(d)) for s, d in perm)
    return tuple(sorted(links))


def runtime_links(runtime) -> tuple:
    """Union of :func:`program_links` over every precompiled failure
    class of a :class:`repro_torch.dist.fault.FaultAwareAllreduce` -- one probe
    plan covers every schedule the runtime can flip to, so probing never
    retraces on failover."""
    links = set()
    for e in runtime.entries:
        if e.k > 0:
            links.update(program_links(e.spec))
    return tuple(sorted(links))


def _pack_probe_waves(links) -> tuple:
    """Greedy split of the directed links into ppermute-legal waves
    (unique sources AND unique destinations per wave)."""
    remaining = list(links)
    waves = []
    while remaining:
        srcs, dsts, take, rest = set(), set(), [], []
        for s, d in remaining:
            if s not in srcs and d not in dsts:
                take.append((s, d))
                srcs.add(s)
                dsts.add(d)
            else:
                rest.append((s, d))
        waves.append(tuple(take))
        remaining = rest
    return tuple(waves)


@dataclass(frozen=True, eq=False)
class LinkProbeSpec:
    """Compiled heartbeat plan: ``links[i]`` is the directed link that
    owns bitmap slot ``i``; each wave carries per-vertex expected-sender
    and slot tables (-1 = this vertex receives nothing that wave)."""
    n: int
    axes: tuple
    links: tuple               # ((src, dst), ...) sorted
    waves: tuple               # tuple[tuple[(src, dst)]], ppermute-legal
    recv_src: tuple            # tuple[np.ndarray (n,)], expected sender
    recv_slot: tuple           # tuple[np.ndarray (n,)], bitmap slot

    @property
    def num_links(self) -> int:
        return len(self.links)


def compile_link_probe(spec_or_runtime) -> LinkProbeSpec:
    """Build the heartbeat plan for a compiled spec or a fault runtime
    (the union of its failure classes -- see :func:`runtime_links`)."""
    if hasattr(spec_or_runtime, "entries"):   # FaultAwareAllreduce
        links = runtime_links(spec_or_runtime)
        n = spec_or_runtime.graph.n
        axes = tuple(spec_or_runtime.axes)
    else:
        links = program_links(spec_or_runtime)
        n = spec_or_runtime.n
        axes = tuple(spec_or_runtime.axes)
    slot = {l: i for i, l in enumerate(links)}
    waves = _pack_probe_waves(links)
    recv_src, recv_slot = [], []
    for wave in waves:
        src = np.full(n, -1, np.int32)
        slt = np.full(n, -1, np.int32)
        for s, d in wave:
            src[d] = s
            slt[d] = slot[(s, d)]
        recv_src.append(src)
        recv_slot.append(slt)
    return LinkProbeSpec(n=n, axes=axes, links=links, waves=waves,
                         recv_src=tuple(recv_src),
                         recv_slot=tuple(recv_slot))


def _probe_failures(fabric, plan):
    """``run(fault_mask=None) -> (L,) float64`` on the fabric's device: 1.0
    in the slot of every link that ends at a local vertex and whose echo
    did not arrive intact, 0.0 elsewhere (so the maximum over the ranks is
    the global failure map)."""
    if fabric.n != plan.n:
        raise ValueError(f"probe plan for n={plan.n}, fabric n={fabric.n}")
    L, dev, lo, hi = plan.num_links, fabric.device, fabric.lo, fabric.hi
    token = (torch.arange(lo, hi, device=dev, dtype=torch.float32)
             + 1.0)[:, None]
    expect = [torch.as_tensor(src[lo:hi], device=dev).float() + 1.0
              for src in plan.recv_src]
    slots = [torch.as_tensor(slt[lo:hi], device=dev).long()
             for slt in plan.recv_slot]
    ones = torch.ones(L, dtype=torch.float32, device=dev)

    def run(fault_mask=None):
        mask = ones if fault_mask is None else torch.as_tensor(
            fault_mask, dtype=torch.float32, device=dev)
        # slot L is the spill row for non-receivers (-1 -> L), cut at the end
        failed = torch.zeros(L + 1, dtype=torch.float64, device=dev)
        for w, wave in enumerate(plan.waves):
            recv = fabric.ppermute(token, wave)[:, 0]
            slot = slots[w]
            live = slot >= 0
            ok = (recv == expect[w]).float() * mask[slot.clamp(min=0)]
            failed.index_add_(0, torch.where(live, slot, L),
                              torch.where(live, 1.0 - ok, 0.0).double())
        return failed[:L]

    return run


def fabric_link_probe(fabric, spec_or_runtime):
    """The heartbeat on a fabric (stacked, or a process-group rank's
    block): returns ``(run, plan)`` where ``run(fault_mask=None) ->
    np.ndarray (L,) of {0., 1.}`` (1.0 = the echo arrived intact), the
    global bitmap on every rank.  One ``(rows, 1)`` token goes through
    ``fabric.ppermute`` once per probe wave; each rank reads the links
    that end at its own vertices, and one ``all_reduce`` over the ranks
    combines them.  ``fault_mask`` (``(L,)``, default all ones) is ANDed
    on the receive side.  The plan's tables live on the fabric's device,
    built once."""
    plan = compile_link_probe(spec_or_runtime)
    failures = _probe_failures(fabric, plan)

    def run(fault_mask=None):
        return _agreed_probe(fabric, failures(fault_mask))[0]

    return run, plan


def _agreed_probe(fabric, failed, *values):
    """``(bitmap, values)``: the global ``(L,)`` link-OK bitmap from every
    rank's local failures and the maximum over the ranks of each of
    ``values``, in one ``all_reduce`` MAX (on the stacked fabric the
    identity)."""
    extra = torch.tensor(values, dtype=torch.float64, device=fabric.device)
    vals = fabric.all_reduce(torch.cat([failed, extra]), dist.ReduceOp.MAX)
    vals = vals.cpu().numpy()
    L = failed.numel()
    return (1.0 - vals[:L]).astype(np.float32), vals[L:]


# ---------------------------------------------------------------------------
# payload checksums (corrupt-wire detection)
# ---------------------------------------------------------------------------

def payload_checksum(x) -> torch.Tensor:
    """``(n, 2)`` checksum of every vertex row of a stacked payload
    ``(n, ...)``: (sum, sum of squares) in f32.  Order-independent, and
    any single-element corruption moves at least one component."""
    flat = x.float().reshape(x.shape[0], -1)
    return torch.stack([flat.sum(1), (flat * flat).sum(1)], 1)


def replication_divergence(chk) -> torch.Tensor:
    """Spread of the per-row checksums ``(n, 2)`` over the vertex rows:
    0.0 when every row holds the same payload (the allreduce
    postcondition), > 0 when a corrupt wire broke replication."""
    return (chk.max(0).values - chk.min(0).values).max()


# ---------------------------------------------------------------------------
# straggler detection (wall-clock quantiles)
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Rolling-median step-time monitor: ``observe(dt)`` returns True when
    ``dt`` exceeds ``ratio`` times the median of the last ``window``
    healthy samples (flagged samples stay out of the baseline so a
    sustained straggler cannot normalize itself)."""

    def __init__(self, window: int = 32, ratio: float = 2.5,
                 min_samples: int = 5):
        self.window = int(window)
        self.ratio = float(ratio)
        self.min_samples = int(min_samples)
        self._times = collections.deque(maxlen=self.window)

    def baseline(self) -> float:
        if not self._times:
            return 0.0
        return float(np.median(self._times))

    def observe(self, dt: float) -> bool:
        if len(self._times) >= self.min_samples \
                and dt > self.ratio * self.baseline():
            return True
        self._times.append(float(dt))
        return False


# ---------------------------------------------------------------------------
# the bundled monitor
# ---------------------------------------------------------------------------

@dataclass
class HealthReport:
    """One detection tick: raw bitmap plus the derived classifications
    the recovery controller consumes."""
    step: int
    links: tuple                      # directed (src, dst) per bitmap slot
    link_ok: np.ndarray               # (L,) bool
    checksum_dev: float = 0.0
    checksum_tol: float = 1e-3
    step_time: float | None = None
    straggler: bool = False
    extras: dict = field(default_factory=dict)

    @property
    def all_links_ok(self) -> bool:
        return bool(self.link_ok.all())

    @property
    def checksum_ok(self) -> bool:
        return self.checksum_dev <= self.checksum_tol

    def failed_directed(self) -> tuple:
        return tuple(l for l, ok in zip(self.links, self.link_ok) if not ok)

    def failed_edges(self) -> frozenset:
        """Canonical undirected edges with at least one dead direction."""
        return frozenset(canon(s, d) for s, d in self.failed_directed())

    def node_suspects(self) -> frozenset:
        """Vertices whose EVERY probed link (both directions) is dead --
        the link-level signature of a lost node."""
        incident: dict = {}
        for (s, d), ok in zip(self.links, self.link_ok):
            for v in (s, d):
                alive, total = incident.get(v, (0, 0))
                incident[v] = (alive + bool(ok), total + 1)
        return frozenset(v for v, (alive, total) in incident.items()
                         if total > 0 and alive == 0)


class HealthMonitor:
    """Caller-side bundle of the three detectors for one fabric and a spec
    or runtime.  ``fabric_or_device`` is a fabric (stacked, or a
    process-group rank's block) or a device, on which a
    :class:`~repro_torch.dist.fabric.StackedFabric` is built.

    ``check(step, fault_mask=, step_time=, checksum_dev=)`` runs the
    heartbeat probe and folds in the caller-measured step time and
    checksum divergence (the train step's ``telemetry=True`` metrics).
    The probe's failures and the step time are reduced in one
    ``all_reduce`` MAX, so over ranks every rank's report is the same: the
    global bitmap and the slowest rank's step time (what
    :class:`StragglerDetector` observes).  :meth:`clock` is the agreed
    time source for the recovery controller."""

    def __init__(self, fabric_or_device, spec_or_runtime,
                 straggler: StragglerDetector | None = None,
                 checksum_tol: float = 1e-3):
        fabric = fabric_or_device
        if not isinstance(fabric, _BlockFabric):
            n = (spec_or_runtime.graph.n
                 if hasattr(spec_or_runtime, "entries")
                 else spec_or_runtime.n)
            fabric = StackedFabric(n, fabric_or_device)
        self.fabric = fabric
        self.plan = compile_link_probe(spec_or_runtime)
        self._failures = _probe_failures(fabric, self.plan)
        self.straggler = straggler or StragglerDetector()
        self.checksum_tol = float(checksum_tol)

    @property
    def links(self) -> tuple:
        return self.plan.links

    def probe(self, fault_mask=None) -> np.ndarray:
        """The global ``(L,)`` link-OK bitmap (see
        :func:`fabric_link_probe`)."""
        return _agreed_probe(self.fabric, self._failures(fault_mask))[0]

    def clock(self) -> float:
        """``time.monotonic()``, the same on every rank: the latest rank's
        reading (one ``all_reduce`` MAX; on the stacked fabric this
        process's own).  Over ranks, the recovery controller's ``clock``,
        so its journal's times agree."""
        t = torch.tensor([time.monotonic()], dtype=torch.float64,
                         device=self.fabric.device)
        return float(self.fabric.all_reduce(t, dist.ReduceOp.MAX).item())

    def check(self, step: int, fault_mask=None, step_time: float | None = None,
              checksum_dev: float = 0.0) -> HealthReport:
        bitmap, (slowest,) = _agreed_probe(
            self.fabric, self._failures(fault_mask),
            -1.0 if step_time is None else float(step_time))
        step_time = None if step_time is None else float(slowest)
        slow = (step_time is not None
                and self.straggler.observe(float(step_time)))
        report = HealthReport(step=step, links=self.plan.links,
                              link_ok=np.asarray(bitmap) > 0.5,
                              checksum_dev=float(checksum_dev),
                              checksum_tol=self.checksum_tol,
                              step_time=step_time, straggler=slow)
        n_failed = int((~report.link_ok).sum())
        _metrics.counter("edst_health_checks_total",
                         "heartbeat/checksum/straggler detection ticks"
                         ).inc()
        if n_failed:
            _metrics.counter("edst_probe_failures_total",
                             "directed links that failed a heartbeat probe"
                             ).inc(n_failed)
        _metrics.gauge("edst_failed_links",
                       "directed links failing the latest probe"
                       ).set(n_failed)
        if not report.checksum_ok:
            _metrics.counter("edst_checksum_failures_total",
                             "payload checksum divergences past tolerance"
                             ).inc()
        if slow:
            _metrics.counter("edst_straggler_flags_total",
                             "steps flagged as stragglers").inc()
        return report
