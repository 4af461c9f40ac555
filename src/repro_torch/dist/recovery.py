"""Closed-loop recovery: classify detector output, walk the escalation
ladder, journal every transition (the reference's
``repro/dist/recovery.py``; its logic is framework-free, and this is the
port's own copy).

:class:`RecoveryController` is the state machine between
:mod:`repro_torch.dist.health` (detect) and
:mod:`repro_torch.dist.fault` (recover).
One ``observe(report)`` call per detection tick returns a
:class:`Decision` telling the training loop what to do *this* tick;
the controller owns the runtime handle, retry counters, and the
structured journal.

The escalation ladder (most transitions are per-cause):

  1. **transient flap** -- a link fails one probe: the link becomes a
     *suspect* and the decision is ``retry`` (stall this tick, bounded
     backoff, re-probe).  If the next probe is clean the flap is
     journaled (cause ``link-flap``) and training resumes on the same
     schedule -- no flip, no recompile.
  2. **persistent link kill** -- a suspect outlives
     ``policy.flap_tolerance`` probes: it is confirmed dead, classified
     into a ``FailureEvent``, and recovered with
     ``runtime.on_failure`` -- a scalar schedule-id flip to the best
     precompiled degraded/rebuilt class (``flip``).
  3. **out-of-class failure** (multi-link burst spanning trees): no
     precompiled class avoids every dead link, so ``with_rebuild`` -- a
     Roskind-Tarjan repack of the actual residual fabric -- runs in a
     background thread while the training loop holds position (``stall`` ticks,
     counted as steps degraded); when the repack lands it is hot-swapped
     in (``hot-swap``) and the training loop rebuilds its step on the new
     runtime's entries.
  4. **payload corruption** -- replication/conservation checksum
     divergence: the just-executed step is discarded (``redo_step``) and
     retried; ``policy.max_retries`` consecutive corrupt retries
     escalate to a full rebuild of the same fabric (a corrupt wire the
     probe cannot localize).
  5. **node loss** -- every probed link of a vertex dead: atomic
     checkpoint (``on_checkpoint``) then elastic rescale
     (``on_rescale`` -> new mesh + runtime), replacing the bare
     ``NoScheduleError`` the runtime alone would raise.

**Over ranks** each rank runs its own controller, and the ranks must
still take the same decision at the same tick (otherwise one runs entry 0
while another runs a degraded entry, and the waves deadlock or sum
garbage).  So every input a decision reads is agreed before it: the
probe's bitmap and the step time come agreed in the report
(:class:`repro_torch.dist.health.HealthMonitor` reduces them in one
``all_reduce``), the controller's ``clock`` is the monitor's agreed one
(:meth:`~repro_torch.dist.health.HealthMonitor.clock`, the latest rank's
reading), the checksum spread is global, and a finished background
rebuild is adopted only at a tick where ``agree`` (the fabric's
``all_true``: one ``all_reduce`` MIN) says every rank's thread has
finished.  The rebuild thread itself issues no collective.  The journal
rows, ticks and times included, are then the same on every rank.

Every transition appends a :class:`JournalEntry` (cause, action,
schedule ids, steps degraded, wall-clock MTTR).  The journal is
*replayable*: :func:`replay_journal` recomputes the final (generation,
schedule-id) pair from the entries alone, so a recovery log can be
audited offline against the runtime state it claims to have produced.
With ``journal_path=`` every entry is ALSO appended to a JSONL file
(monotonic ``seq`` numbers, one flush per entry) so post-mortems survive
the process; ``replay_journal`` accepts the file form directly, and the
same choke point increments
``edst_recovery_transitions_total{cause,action}`` in
:mod:`repro_torch.telemetry.metrics` -- journal and counters reconcile by
construction.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

from ..analysis.verify import check_schedule_id
from ..core.fault import FailureEvent
from ..telemetry import metrics as _metrics
from .fault import NoScheduleError

CAUSES = ("link-flap", "link-kill", "link-burst", "payload-corruption",
          "straggler", "node-loss")
ACTIONS = ("retry", "flip", "rebuild", "hot-swap", "rescale", "observe")


@dataclass(frozen=True)
class Decision:
    """What the training loop should do this tick."""
    action: str                 # "none" | one of ACTIONS
    schedule_id: int            # id to feed the step's traced switch
    stall: bool = False        # do not run a train step this tick
    redo_step: bool = False    # last step's result is suspect: roll back
    backoff_s: float = 0.0     # sleep before the next tick
    runtime_changed: bool = False  # rebuild the step: the entries changed
    detail: dict = field(default_factory=dict)


@dataclass
class JournalEntry:
    """One structured recovery-journal row."""
    step: int                  # detection tick
    cause: str                 # one of CAUSES
    action: str                # one of ACTIONS
    from_schedule: int
    to_schedule: int
    generation: int            # runtime generation AFTER the action
    steps_degraded: int = 0    # observe ticks from detection to recovery
    mttr_s: float | None = None  # wall-clock detection -> recovered
    detail: dict = field(default_factory=dict)

    def to_row(self) -> dict:
        return {"step": self.step, "cause": self.cause,
                "action": self.action,
                "from_schedule": self.from_schedule,
                "to_schedule": self.to_schedule,
                "generation": self.generation,
                "steps_degraded": self.steps_degraded,
                "mttr_s": self.mttr_s, "detail": dict(self.detail)}


def load_journal(path) -> list:
    """Parse a JSONL journal file back into :class:`JournalEntry` rows,
    asserting the ``seq`` numbers are strictly monotonic (a torn or
    re-ordered file is a corrupt post-mortem and raises)."""
    entries, last_seq = [], -1
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            seq = row.pop("seq", None)
            if not isinstance(seq, int) or seq <= last_seq:
                raise ValueError(f"journal {path} line {ln + 1}: seq "
                                 f"{seq!r} not monotonic (last {last_seq})")
            last_seq = seq
            entries.append(JournalEntry(**row))
    return entries


def replay_journal(journal) -> tuple:
    """Re-derive the final ``(generation, schedule_id)`` from journal
    entries alone -- the offline audit the soak tests assert against the
    live controller state.  Accepts a list of :class:`JournalEntry` (or
    plain ``to_row()`` dicts) or the path of a JSONL journal file."""
    if isinstance(journal, (str, os.PathLike)):
        journal = load_journal(journal)
    gen, sid = 0, 0
    for e in journal:
        if isinstance(e, dict):
            e = JournalEntry(**{k: v for k, v in e.items() if k != "seq"})
        if e.action in ("flip", "hot-swap", "rescale"):
            gen, sid = e.generation, e.to_schedule
    return gen, sid


@dataclass
class RecoveryPolicy:
    """Escalation knobs (see the ladder in the module docstring)."""
    flap_tolerance: int = 1     # failed probes before a suspect is confirmed
    max_retries: int = 3        # consecutive corrupt redos before rebuild
    backoff_base_s: float = 0.05  # retry backoff: base * 2^attempt
    backoff_cap_s: float = 2.0
    checksum_tol: float = 1e-3
    background_rebuild: bool = True  # False: rebuild inline (deterministic)
    prefer: str = "max_k"       # on_failure preference

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_base_s * (2 ** max(attempt - 1, 0)),
                   self.backoff_cap_s)


class RecoveryController:
    """The detect->classify->escalate->recover state machine.

    ``on_checkpoint()`` and ``on_rescale(event)`` are training-loop callbacks
    for the node-loss rung: the first must atomically persist training
    state, the second must deliver a NEW
    :class:`repro_torch.dist.fault.FaultAwareAllreduce` for the rescaled
    fabric (and is free to swap the mesh/step behind the scenes).  With
    no rescale callback a node loss parks the controller in ``stall``
    and journals ``rescale`` as required-but-unavailable, so training loops
    without elasticity degrade to a loud no-progress state instead of an
    unhandled exception.

    ``agree(flag) -> bool`` (default: the flag itself) is whether a local
    flag holds on every rank; over ranks pass the fabric's ``all_true``
    (see the module docstring), and ``clock`` an agreed one."""

    def __init__(self, runtime, policy: RecoveryPolicy | None = None,
                 on_checkpoint=None, on_rescale=None, clock=time.monotonic,
                 journal_path=None, agree=None):
        self.runtime = runtime
        self.agree = agree
        self.policy = policy or RecoveryPolicy()
        self.on_checkpoint = on_checkpoint
        self.on_rescale = on_rescale
        self.clock = clock
        self.generation = 0
        self.journal: list = []
        self.journal_path = journal_path   # JSONL sink (None: memory only)
        self._seq = 0
        self.state = "healthy"   # healthy | suspect | degraded | rebuilding
        #                          | stalled
        self._suspects: dict = {}     # edge -> (first_tick, first_time, count)
        self._dead: set = set()       # confirmed dead edges (this fabric)
        self._retries = 0             # consecutive corrupt redos
        self._rebuild: dict | None = None  # in-flight background rebuild
        self._stall_cause: tuple | None = None

    # -- public surface -----------------------------------------------------

    @property
    def schedule_id(self) -> int:
        return self.runtime.active

    def journal_rows(self) -> list:
        return [e.to_row() for e in self.journal]

    def observe(self, report) -> Decision:
        """Consume one :class:`repro_torch.dist.health.HealthReport`; returns
        the decision for this tick.  Severity order: an adoptable
        finished rebuild first, then node loss, links, checksums,
        stragglers."""
        now = self.clock()
        adopted = self._maybe_adopt_rebuild(report.step, now)
        if adopted is not None:
            return adopted
        if self._rebuild is not None:
            return self._stall_decision(report.step)

        nodes = report.node_suspects()
        if nodes:
            return self._on_node_loss(report.step, nodes, now)

        decision = self._on_links(report, now)
        if decision is not None:
            return decision

        if not report.checksum_ok:
            return self._on_corruption(report, now)
        self._retries = 0

        if report.straggler:
            self._journal(report.step, "straggler", "observe",
                          self.schedule_id, self.schedule_id, 0, 0.0,
                          {"step_time": report.step_time})
        return Decision("none", self.schedule_id)

    # -- journal helpers ----------------------------------------------------

    def _journal(self, step, cause, action, from_sid, to_sid,
                 steps_degraded, mttr_s, detail=None) -> JournalEntry:
        bad = check_schedule_id(len(self.runtime.entries), to_sid)
        if bad is not None:  # defence in depth: never journal a bogus flip
            raise NoScheduleError(str(bad))
        e = JournalEntry(step=step, cause=cause, action=action,
                         from_schedule=from_sid, to_schedule=to_sid,
                         generation=self.generation,
                         steps_degraded=steps_degraded, mttr_s=mttr_s,
                         detail=detail or {})
        self.journal.append(e)
        _metrics.counter(
            "edst_recovery_transitions_total",
            "recovery journal transitions by cause and action"
        ).inc(cause=cause, action=action)
        if self.journal_path is not None:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps({"seq": self._seq, **e.to_row()}) + "\n")
            self._seq += 1
        return e

    # -- links: flap / kill / burst -----------------------------------------

    def _on_links(self, report, now) -> Decision | None:
        failed = report.failed_edges() - self._dead
        cleared = [e for e in self._suspects if e not in failed]
        for edge in cleared:   # transient flap healed: journal + resume
            tick0, t0, count = self._suspects.pop(edge)
            self._journal(report.step, "link-flap", "retry",
                          self.schedule_id, self.schedule_id,
                          count, now - t0, {"link": list(edge)})
        confirmed = set()
        for edge in failed:
            tick0, t0, count = self._suspects.get(
                edge, (report.step, now, 0))
            count += 1
            self._suspects[edge] = (tick0, t0, count)
            if count > self.policy.flap_tolerance:
                confirmed.add(edge)
        if confirmed:
            return self._on_confirmed_dead(report.step, confirmed, now)
        if self._suspects:   # suspects pending: hold position, re-probe
            self.state = "suspect"
            attempt = max(c for _, _, c in self._suspects.values())
            return Decision("retry", self.schedule_id, stall=True,
                            backoff_s=self.policy.backoff(attempt),
                            detail={"suspects": sorted(
                                list(e) for e in self._suspects)})
        if self.state == "suspect":
            self.state = "degraded" if self._dead else "healthy"
        return None

    def _on_confirmed_dead(self, step, confirmed, now) -> Decision:
        tick0 = min(self._suspects[e][0] for e in confirmed)
        t0 = min(self._suspects[e][1] for e in confirmed)
        for e in confirmed:
            self._suspects.pop(e, None)
        self._dead |= confirmed
        cause = "link-burst" if len(self._dead) > 1 else "link-kill"
        event = FailureEvent(links=frozenset(self._dead))
        from_sid = self.schedule_id
        try:
            self.runtime = self.runtime.on_failure(
                event, prefer=self.policy.prefer)
        except NoScheduleError:
            # out of the precompiled classes: Roskind-Tarjan repack in
            # the background, hold position meanwhile
            self._start_rebuild(step, event, cause, tick0, t0)
            return self._stall_decision(step)
        self.state = "degraded"
        self._journal(step, cause, "flip", from_sid, self.schedule_id,
                      step - tick0, now - t0,
                      {"dead_links": sorted(list(e) for e in confirmed),
                       "entry": self.runtime.entry.name,
                       "k": self.runtime.entry.k})
        return Decision("flip", self.schedule_id,
                        detail={"entry": self.runtime.entry.name,
                                "from_schedule": from_sid})

    # -- out-of-class: background rebuild + hot swap ------------------------

    def _start_rebuild(self, step, event, cause, tick0, t0) -> None:
        self.state = "rebuilding"
        box = {"step": step, "cause": cause, "tick0": tick0, "t0": t0,
               "event": event, "result": None, "error": None,
               "thread": None}

        def work():
            try:
                box["result"] = self.runtime.with_rebuild(event)
            except Exception as exc:  # surfaced on adoption
                box["error"] = exc

        if self.policy.background_rebuild:
            th = threading.Thread(target=work, name="edst-rebuild",
                                  daemon=True)
            box["thread"] = th
            th.start()
        else:
            work()
        self._rebuild = box

    def _maybe_adopt_rebuild(self, step, now) -> Decision | None:
        box = self._rebuild
        if box is None:
            return None
        th = box["thread"]
        done = th is None or not th.is_alive()
        if self.agree is not None:
            done = self.agree(done)     # every rank's thread has finished
        if not done:
            return self._stall_decision(step)
        if th is not None:
            th.join()
        self._rebuild = None
        if box["error"] is not None:
            raise NoScheduleError(
                f"background rebuild failed: {box['error']}")
        from_sid = self.schedule_id
        self.runtime = box["result"]
        self.generation += 1
        self._dead = set()      # the rebuilt schedule avoids them by
        self._suspects = {}     # construction; fresh detection state
        self.state = "degraded"
        self._journal(step, box["cause"], "hot-swap", from_sid,
                      self.schedule_id, step - box["tick0"],
                      now - box["t0"],
                      {"k": self.runtime.k,
                       "dead_links": sorted(
                           list(e) for e in box["event"].links)})
        return Decision("hot-swap", self.schedule_id, runtime_changed=True,
                        detail={"k": self.runtime.k})

    def _stall_decision(self, step) -> Decision:
        return Decision("rebuild", self.schedule_id, stall=True,
                        backoff_s=self.policy.backoff(1),
                        detail={"state": self.state})

    # -- corruption ---------------------------------------------------------

    def _on_corruption(self, report, now) -> Decision:
        self._retries += 1
        if self._retries > self.policy.max_retries:
            # a wire corrupting every retry that no probe localizes:
            # recompile the whole fabric (same graph, fresh programs)
            event = FailureEvent(links=frozenset(self._dead))
            self._start_rebuild(report.step, event, "payload-corruption",
                                report.step, now)
            self._retries = 0
            return self._stall_decision(report.step)
        self._journal(report.step, "payload-corruption", "retry",
                      self.schedule_id, self.schedule_id, 1, 0.0,
                      {"checksum_dev": report.checksum_dev,
                       "attempt": self._retries})
        return Decision("retry", self.schedule_id, redo_step=True,
                        backoff_s=self.policy.backoff(self._retries),
                        detail={"checksum_dev": report.checksum_dev})

    # -- node loss: checkpoint + elastic rescale ----------------------------

    def _on_node_loss(self, step, nodes, now) -> Decision:
        event = FailureEvent(nodes=frozenset(nodes),
                             links=frozenset(self._dead))
        if self.on_rescale is None:
            self.state = "stalled"
            if self._stall_cause is None:   # journal once, stall forever
                self._stall_cause = ("node-loss", now)
                self._journal(step, "node-loss", "observe",
                              self.schedule_id, self.schedule_id, 0, None,
                              {"nodes": sorted(nodes),
                               "error": "no on_rescale callback"})
            return Decision("rescale", self.schedule_id, stall=True,
                            detail={"nodes": sorted(nodes)})
        from_sid = self.schedule_id
        if self.on_checkpoint is not None:
            self.on_checkpoint()
        new_runtime = self.on_rescale(event)
        if new_runtime is None:
            raise NoScheduleError(
                "on_rescale returned no runtime for node loss "
                f"{sorted(nodes)}")
        self.runtime = new_runtime
        self.generation += 1
        self._dead = set()
        self._suspects = {}
        self.state = "degraded"
        self._journal(step, "node-loss", "rescale", from_sid,
                      self.schedule_id, 0, self.clock() - now,
                      {"nodes": sorted(nodes), "n": new_runtime.graph.n,
                       "k": new_runtime.k})
        return Decision("rescale", self.schedule_id, runtime_changed=True,
                        detail={"nodes": sorted(nodes),
                                "n": new_runtime.graph.n})
