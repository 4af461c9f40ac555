"""Seeded chaos: deterministic fault traces injected at the telemetry
boundary (the port's copy of the reference's ``repro/dist/chaos.py``; its
random draws are numpy's, call for call, so one seed gives one trace in
both packages).

The recovery loop (:mod:`repro_torch.dist.health` detects,
:mod:`repro_torch.dist.recovery` escalates, :mod:`repro_torch.dist.fault`
recovers) is only trustworthy if it survives *sustained* injected
failure.  This module generates reproducible fault traces against a
:class:`repro_torch.dist.fault.FaultAwareAllreduce` and replays them
through the heartbeat probe's ``fault_mask`` -- wire faults are injected
where a real fabric would report them, without patching any collective,
so the detection/recovery path exercised is exactly the production one.

A trace is a tuple of :class:`ChaosEvent`, one per fault, chosen so
every rung of the escalation ladder fires:

  * ``flap``   -- one edge dead for a single detection tick (transient);
  * ``kill``   -- one edge dead forever, chosen to stay inside the
    precompiled failure classes (a scalar schedule-id flip recovers it);
  * ``burst``  -- a multi-link burst grown by :func:`out_of_class_burst`
    until NO precompiled class survives but the residual fabric is still
    connected, forcing the background ``with_rebuild`` + hot-swap path;
  * ``straggler``  -- wall-clock dilation of reported step times;
  * ``corruption`` -- checksum divergence injected into the telemetry
    stream (a healthy stacked fabric cannot corrupt payloads physically,
    so corruption enters at the detector output; the checksum machinery
    itself is unit-tested on genuinely divergent arrays);
  * ``node``   -- every link incident to one vertex dead (the probe
    signature of node loss), driving checkpoint + elastic rescale.

:class:`ChaosInjector` replays a trace tick by tick and answers the four
questions the soak harness asks each tick: which links to mask in the
probe, how much to dilate the reported step time, what checksum
deviation to report, and which node (if any) just died.  The training
loop that drives it, and the elastic rescale a node loss ends in, are
:func:`repro_torch.launch.elastic.chaos_loop`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.fault import FailureEvent
from ..core.graph import canon
from ..telemetry import metrics as _metrics
from .health import LinkProbeSpec, runtime_links

KINDS = ("flap", "kill", "burst", "straggler", "corruption", "node")


@dataclass(frozen=True)
class ChaosEvent:
    """One injected fault.  ``duration`` counts detection ticks; ``-1``
    means permanent.  ``magnitude`` is the straggler time-dilation factor
    or the injected checksum deviation."""
    tick: int
    kind: str
    links: tuple = ()            # canonical undirected edges
    node: int | None = None
    duration: int = -1
    magnitude: float = 0.0

    def describe(self) -> str:
        what = {"flap": f"flap {list(self.links)}",
                "kill": f"kill {list(self.links)}",
                "burst": f"burst x{len(self.links)} {list(self.links)}",
                "straggler": f"straggler x{self.magnitude:.1f}",
                "corruption": f"corruption dev={self.magnitude:g}",
                "node": f"node {self.node} lost"}[self.kind]
        return f"t={self.tick}: {what}"


# ---------------------------------------------------------------------------
# trace generation
# ---------------------------------------------------------------------------

def out_of_class_burst(runtime, rng, already_dead=frozenset()) -> tuple:
    """Grow a random multi-link burst until no precompiled failure class
    of ``runtime`` survives it (``valid_ids == []``) while the residual
    fabric stays connected -- the smallest chaos that forces the
    ``with_rebuild`` Roskind-Tarjan path instead of a schedule flip."""
    edges = sorted({canon(s, d) for s, d in runtime_links(runtime)})
    order = [e for e in edges if e not in already_dead]
    rng.shuffle(order)
    dead = set(already_dead)
    picked = []
    for e in order:
        trial = frozenset(dead | {e})
        ev = FailureEvent(links=trial)
        residual = runtime.graph.without_edges(ev.dead_links(runtime.graph))
        if not residual.is_connected():
            continue
        dead.add(e)
        picked.append(e)
        if not runtime.valid_ids(ev):
            return tuple(picked)
    raise ValueError(
        "no connected out-of-class burst exists on this fabric "
        f"(n={runtime.graph.n}, k={runtime.k})")


def _alive_edge(runtime, rng, dead, in_class: bool):
    """A random probed edge whose death keeps the residual connected;
    ``in_class=True`` additionally requires some precompiled schedule to
    survive (so the event recovers via a flip, not a rebuild)."""
    edges = sorted({canon(s, d) for s, d in runtime_links(runtime)})
    order = [e for e in edges if e not in dead]
    rng.shuffle(order)
    for e in order:
        ev = FailureEvent(links=frozenset(dead | {e}))
        residual = runtime.graph.without_edges(ev.dead_links(runtime.graph))
        if not residual.is_connected():
            continue
        if in_class and not runtime.valid_ids(ev):
            continue
        return e
    raise ValueError("no eligible edge left on the fabric")


def make_trace(runtime, n_ticks: int, seed: int = 0, kinds=KINDS,
               gap: int = 5) -> tuple:
    """Seeded fault trace for ``runtime``: one event per requested kind,
    in order, spaced ``gap`` (+ seeded jitter) detection ticks apart so
    each recovery settles before the next fault lands.  Events are
    constrained against the INITIAL runtime -- kinds after ``burst`` or
    ``node`` land on whatever fabric recovery produced, which is exactly
    the point of a soak."""
    rng = np.random.default_rng(seed)
    events = []
    dead: set = set()
    t = 2
    for kind in kinds:
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r} (not in {KINDS})")
        if kind == "flap":
            e = _alive_edge(runtime, rng, dead, in_class=True)
            events.append(ChaosEvent(t, "flap", links=(e,), duration=1))
        elif kind == "kill":
            e = _alive_edge(runtime, rng, dead, in_class=True)
            dead.add(e)
            events.append(ChaosEvent(t, "kill", links=(e,)))
        elif kind == "burst":
            picked = out_of_class_burst(runtime, rng, frozenset(dead))
            dead.update(picked)
            events.append(ChaosEvent(t, "burst", links=tuple(picked)))
        elif kind == "straggler":
            events.append(ChaosEvent(t, "straggler", duration=2,
                                     magnitude=float(rng.uniform(3.0, 5.0))))
        elif kind == "corruption":
            events.append(ChaosEvent(t, "corruption", duration=1,
                                     magnitude=1.0))
        elif kind == "node":
            v = int(rng.integers(runtime.graph.n))
            events.append(ChaosEvent(t, "node", node=v))
        t += gap + int(rng.integers(0, 2))
    if events and events[-1].tick + gap > n_ticks:
        raise ValueError(
            f"trace needs >= {events[-1].tick + gap} ticks to settle; "
            f"got n_ticks={n_ticks}")
    return tuple(events)


def trace_summary(trace) -> str:
    return "\n".join(ev.describe() for ev in trace)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

@dataclass
class ChaosInjector:
    """Tick-by-tick replay of a trace.  Call :meth:`advance` once per
    detection tick, then query the injection surfaces: ``fault_mask``
    (for the heartbeat probe), ``time_dilation`` (multiply the measured
    step time), ``checksum_injection`` (add to the reported checksum
    deviation).  After an elastic rescale removed the dead node from the
    fabric, call :meth:`clear_fabric_state` -- the replacement fabric's
    wires are healthy."""
    trace: tuple
    tick: int = -1
    dead_edges: set = field(default_factory=set)
    dead_nodes: set = field(default_factory=set)
    fired: list = field(default_factory=list)
    _expiry: dict = field(default_factory=dict)   # edge -> expiry tick
    _straggle_until: int = -1
    _straggle_mag: float = 1.0
    _corrupt_until: int = -1
    _corrupt_mag: float = 0.0

    def __post_init__(self):
        self.trace = tuple(sorted(self.trace, key=lambda e: e.tick))

    @property
    def done(self) -> bool:
        return len(self.fired) == len(self.trace)

    def advance(self) -> tuple:
        """Enter the next tick; expire transient faults, fire new events.
        Returns the events that began this tick."""
        self.tick += 1
        for e, until in list(self._expiry.items()):
            if self.tick >= until:
                self.dead_edges.discard(e)
                del self._expiry[e]
        fired = tuple(ev for ev in self.trace if ev.tick == self.tick)
        for ev in fired:
            if ev.kind in ("flap", "kill", "burst"):
                self.dead_edges.update(ev.links)
                if ev.duration > 0:
                    for e in ev.links:
                        self._expiry[e] = self.tick + ev.duration
            elif ev.kind == "node":
                self.dead_nodes.add(ev.node)
            elif ev.kind == "straggler":
                self._straggle_until = self.tick + ev.duration
                self._straggle_mag = ev.magnitude
            elif ev.kind == "corruption":
                self._corrupt_until = self.tick + ev.duration
                self._corrupt_mag = ev.magnitude
        self.fired.extend(fired)
        for ev in fired:
            _metrics.counter("edst_chaos_events_total",
                             "injected chaos events by kind"
                             ).inc(kind=ev.kind)
        return fired

    def fault_mask(self, plan: LinkProbeSpec) -> np.ndarray:
        """(L,) float mask over ``plan.links``: 0.0 on wires this tick's
        fault state kills (either direction of a dead edge, or any wire
        touching a dead node)."""
        mask = np.ones(plan.num_links, np.float32)
        for i, (s, d) in enumerate(plan.links):
            if (canon(s, d) in self.dead_edges or s in self.dead_nodes
                    or d in self.dead_nodes):
                mask[i] = 0.0
        return mask

    def time_dilation(self) -> float:
        return self._straggle_mag if self.tick < self._straggle_until else 1.0

    def checksum_injection(self) -> float:
        return self._corrupt_mag if self.tick < self._corrupt_until else 0.0

    def clear_fabric_state(self) -> None:
        """The fabric was replaced (elastic rescale): dead wires and the
        lost node are no longer part of it."""
        self.dead_edges.clear()
        self.dead_nodes.clear()
        self._expiry.clear()
