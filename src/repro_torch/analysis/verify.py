"""Static wave-program verifier for every compiled EDST allreduce engine
(the port's copy of the reference's ``repro/analysis/verify.py``).

The paper's guarantees (edge-disjointness, full-cardinality spanning,
bounded depth) make k-tree collectives safe to overlap.  This module
proves a compiled wave program legal in O(messages), without running an
engine or the simulator:

  * **ppermute legality** -- every wave's (src, dst) pairs form a partial
    bijection (unique sources AND unique destinations);
  * **routing-table agreement** -- the send tables and the receive
    flags/rows describe the same messages (no dropped or stray receives,
    no arrival landing in a different chunk row than was shipped);
  * **link-race freedom** -- in a segment-streamed program (per-tree,
    fused, pipelined) each *directed* link is claimed by at most one
    wave across the whole program, so at pipeline step t wave w (moving
    segment t-w) can never collide with wave w' (moving segment t-w'):
    overlap is safe for every segment count S.  This is the static
    equivalent of the simulator's max_link_load == 1 check;
  * **happens-before closure** -- every message's wave is strictly later
    than all of its reduce/gather predecessors' waves (the list
    scheduler's delivery contract, re-derived from the tables);
  * **tree recovery** -- the k trees are rebuilt from the routing tables
    themselves (NOT trusted from the schedule) and checked: one parent
    per non-root vertex, a single root, no cycles, n-1 edges
    (spanning), broadcast edges exactly the reversed reduce edges, and
    pairwise edge-disjointness across trees (the EDST property);
  * **stripe-window conservation** (striped engine) -- per tree edge the
    four message kinds appear exactly once each, the up/down slot
    windows are exact circular complements (so every owner slot crosses
    every tree edge exactly once per phase), the below-window length
    equals the recovered subtree size, and child windows nest inside
    their parent's;
  * **phase/op homogeneity** -- striped waves are op-homogeneous
    (accumulate vs overwrite), the quantized pipelined program is
    phase-separated at ``q8_boundary``, and per-wave ``rows`` /
    ``sole_add`` metadata matches the tables executors specialize on.

Violation codes (each maps to one invariant; ``tests/test_torch_verify.py``
holds every mutation's code to the reference's):

  ==================== ====================================================
  code                 invariant
  ==================== ====================================================
  ``spec-meta``        spec-level metadata broken (axes, row range)
  ``wave-illegal``     a wave reuses a source or destination
  ``link-race``        a directed link claimed by two waves (segment race)
  ``recv-dropped``     an arrival has no landing flag at its destination
  ``row-misroute``     arrival lands in a different row/window than shipped
  ``table-stray``      receive flag / metadata without a matching arrival
  ``op-mixed``         wave or phase mixes accumulate/overwrite semantics
  ``tree-malformed``   recovered routing is not a spanning tree
  ``phase-mismatch``   broadcast edges are not the reversed reduce edges
  ``edge-disjointness``two trees route over the same physical link
  ``message-conservation`` wrong per-edge or per-program message multiset
  ``happens-before``   a message scheduled no later than a predecessor
  ``stripe-conservation`` slot windows do not partition the owner circle
  ``stale-ownership``  spec.trees ownership slots disagree with the routed
                       windows (stripe table not re-striped after failover)
  ``depth-mismatch``   spec.depth disagrees with the recovered trees
  ``sid-out-of-range`` a schedule id outside a runtime's precompiled entry
                       table (a Python index would wrap a negative one to
                       a wrong failure-class program)
  ==================== ====================================================

Levels: ``"cheap"`` runs the single-pass wave scans plus the link-race
check (the production assert mode); ``"full"`` adds tree recovery,
happens-before, edge-disjointness, stripe conservation and depth (the
test mode).  The spec compilers in ``repro_torch.core.collectives``,
``core.product_schedule``, ``core.schedule_search`` and
``dist.tree_allreduce.spec_from_schedule`` call :func:`assert_valid`
under their ``verify=`` flag, resolved from the ``REPRO_VERIFY_SPECS``
environment variable (``"cheap"`` by default; the tests set ``full``).

:func:`hlo_contract_for` states what a correct executor run of a spec
must issue (the reference's HLO contract, with the reference's
arithmetic): :func:`repro_torch.analysis.hlo.lint_hlo` holds a recording
of the run's fabric ``ppermute`` calls to it.  The CLI's ``--trace DIR`` writes each verified spec's
predicted Perfetto trace into ``DIR`` through
:mod:`repro_torch.telemetry.trace`, as the reference's does.

CLI::

    python -m repro_torch.analysis.verify --all-engines --topologies paper5

verifies every engine's compiled spec on the five paper topology
families statically; ``--simulate`` additionally replays the NumPy
packet simulators; ``--stats`` prints waves, depth and the
``CostModel`` makespan of a 64 MiB allreduce per engine x topology.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.collectives import (AG_DOWN, AG_UP, BCAST, REDUCE, RS_DOWN,
                                RS_UP, FusedAllreduceSpec,
                                PipelinedAllreduceSpec,
                                StripedCollectiveSpec, _RS_KINDS,
                                _striped_op, striped_tables)
from ..core.graph import canon
from .hlo import HloContract

ENGINES = ("per_tree", "fused", "pipelined", "striped")
LEVELS = ("cheap", "full")

_AG_KINDS = frozenset({AG_UP, AG_DOWN})
_ALL_STRIPED_KINDS = frozenset({RS_UP, RS_DOWN, AG_UP, AG_DOWN})
_UP_OF = {_RS_KINDS: RS_UP, _AG_KINDS: AG_UP, _ALL_STRIPED_KINDS: RS_UP}
# which kinds carry the child's *below* window (subtree slots); the other
# two carry the complementary *above* window
_BELOW_KINDS = frozenset({RS_DOWN, AG_UP})
_KIND_NAME = {REDUCE: "reduce", BCAST: "bcast", RS_UP: "RS_UP",
              RS_DOWN: "RS_DOWN", AG_UP: "AG_UP", AG_DOWN: "AG_DOWN"}


@dataclass(frozen=True)
class Violation:
    code: str
    detail: str

    def __str__(self):
        return f"[{self.code}] {self.detail}"


@dataclass
class VerifyReport:
    """Outcome of one static verification pass."""
    engine: str
    n: int
    k: int
    level: str
    messages: int
    waves: int
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self, limit: int = 8) -> str:
        head = (f"{self.engine}: n={self.n} k={self.k} "
                f"{self.messages} messages / {self.waves} waves "
                f"[{self.level}] -> "
                + ("ok" if self.ok else f"{len(self.violations)} violation(s)"))
        lines = [str(v) for v in self.violations[:limit]]
        if len(self.violations) > limit:
            lines.append(f"... and {len(self.violations) - limit} more")
        return "\n".join([head] + [f"  - {ln}" for ln in lines])


class SpecVerificationError(ValueError):
    """A compiled spec failed static verification."""

    def __init__(self, report: VerifyReport, context: str = ""):
        self.report = report
        msg = report.summary()
        if context:
            msg = f"{context}: {msg}"
        super().__init__(msg)


def check_schedule_id(num_entries: int, schedule_id: int) -> Violation | None:
    """The ``sid-out-of-range`` check.  The port runs a failure class by
    indexing a table of prebuilt callables, and a Python index wraps a
    negative id (``entries[-1]`` is the last class), so an id outside
    ``[0, num_entries)`` would run the WRONG failure-class program
    without a word.  Every caller that selects an entry by id gates it
    through this check."""
    if 0 <= schedule_id < num_entries:
        return None
    return Violation(
        "sid-out-of-range",
        f"schedule id {schedule_id} outside the precompiled entry table "
        f"[0, {num_entries}); lax.switch would clamp it to branch "
        f"{min(max(schedule_id, 0), num_entries - 1)}")


# ---------------------------------------------------------------------------
# engine dispatch
# ---------------------------------------------------------------------------

def engine_of(spec) -> str:
    """Engine name of a compiled spec.  The per-tree form lives in
    ``repro_torch.dist.tree_allreduce``, so it is duck-typed on its
    attributes instead of imported here."""
    if isinstance(spec, PipelinedAllreduceSpec):
        return "pipelined"
    if isinstance(spec, FusedAllreduceSpec):
        return "fused"
    if isinstance(spec, StripedCollectiveSpec):
        return "striped"
    if (hasattr(spec, "trees") and hasattr(spec, "axes")
            and hasattr(spec, "n")
            and all(hasattr(t, "reduce_rounds") for t in spec.trees)):
        return "per_tree"
    raise TypeError(f"not a compiled allreduce spec: {type(spec).__name__}")


# ---------------------------------------------------------------------------
# shared wave / program checks
# ---------------------------------------------------------------------------

def _scan_perm(w: int, perm, label: str, out: list) -> None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs):
        dup = sorted(s for s in set(srcs) if srcs.count(s) > 1)[0]
        out.append(Violation("wave-illegal",
                             f"{label}[{w}]: source {dup} sends twice in one "
                             "wave (ppermute needs unique sources)"))
    if len(set(dsts)) != len(dsts):
        dup = sorted(d for d in set(dsts) if dsts.count(d) > 1)[0]
        out.append(Violation("wave-illegal",
                             f"{label}[{w}]: destination {dup} receives twice "
                             "in one wave (ppermute needs unique "
                             "destinations)"))


def _check_link_race(msgs, label: str, out: list) -> None:
    """Each directed link at most once across the WHOLE program: with
    segment streaming, wave w moves segment t-w at step t, so two waves
    sharing a directed link would put two in-flight segments on it."""
    first: dict = {}
    for w, _, _, s, d in msgs:
        if (s, d) in first and first[(s, d)] != w:
            out.append(Violation(
                "link-race",
                f"{label}: directed link {s}->{d} claimed by waves "
                f"{first[(s, d)]} and {w}; segment streaming would put two "
                "in-flight segments on it in one step"))
        else:
            first.setdefault((s, d), w)


def _recover_parent(n: int, up_edges, j: int, label: str, out: list):
    """Rebuild one tree from its child->parent messages and check it is a
    spanning tree: single parent, single root, acyclic, n-1 edges.
    Returns (parent, root, depth_of, clean)."""
    parent: dict = {}
    clean = True
    for c, p in up_edges:
        if c in parent:
            out.append(Violation(
                "tree-malformed",
                f"{label}: tree {j}: vertex {c} has two parents "
                f"({parent[c]} and {p})"))
            clean = False
        else:
            parent[c] = p
    if n > 1 and len(parent) != n - 1:
        out.append(Violation(
            "tree-malformed",
            f"{label}: tree {j}: {len(parent)} up edges; a spanning tree "
            f"of {n} vertices needs {n - 1}"))
        clean = False
    roots = [v for v in range(n) if v not in parent]
    if len(roots) != 1:
        out.append(Violation(
            "tree-malformed",
            f"{label}: tree {j}: {len(roots)} root candidates "
            f"{roots[:4]} (need exactly one vertex that never sends up)"))
        clean = False
    root = roots[0] if len(roots) == 1 else None
    depth_of = {root: 0} if root is not None else {}
    for v0 in range(n):
        if v0 in depth_of:
            continue
        chain, seen, u = [], set(), v0
        cyclic = False
        while u not in depth_of:
            if u in seen:
                out.append(Violation(
                    "tree-malformed",
                    f"{label}: tree {j}: parent cycle through vertex {u}"))
                clean, cyclic = False, True
                break
            if u not in parent:     # stray extra root: anchor at depth 0
                depth_of[u] = 0
                break
            seen.add(u)
            chain.append(u)
            u = parent[u]
        if cyclic:
            return parent, root, depth_of, False
        base = depth_of.get(u, 0)
        for i, x in enumerate(reversed(chain)):
            depth_of[x] = base + i + 1
    return parent, root, depth_of, clean


def _check_trees(n: int, k: int, msgs, spec_depth, label: str, out: list,
                 hb_only: bool = False, depth_is_min: bool = False) -> None:
    """Full tree-recovery suite for the chunk engines (REDUCE/BCAST
    messages).  With ``hb_only`` (the pipelined q8 program -- same trees,
    different wave assignment) only happens-before is re-checked.  With
    ``depth_is_min`` (per-tree engine: ``_split_unique`` may split one
    BFS level into several ppermute-legal sub-rounds) ``spec_depth`` is a
    lower bound on rounds, not an exact BFS depth."""
    per_tree: dict = {j: [] for j in range(k)}
    for m in msgs:
        if 0 <= m[1] < k:
            per_tree[m[1]].append(m)
    scratch: list = []
    struct_out = scratch if hb_only else out
    edge_owner: dict = {}
    max_depth = 0
    structural = len(out)
    for j in range(k):
        red = [(s, d) for _, _, kind, s, d in per_tree[j] if kind == REDUCE]
        parent, root, depth_of, clean = _recover_parent(
            n, red, j, label, struct_out)
        rwave, bwave, bsrc = {}, {}, {}
        for w, _, kind, s, d in per_tree[j]:
            if kind == REDUCE:
                rwave.setdefault(s, w)
            else:
                if d in bwave:
                    struct_out.append(Violation(
                        "message-conservation",
                        f"{label}: tree {j}: vertex {d} receives two "
                        "broadcast messages"))
                else:
                    bwave[d], bsrc[d] = w, s
        if not hb_only:
            if n > 1 and not per_tree[j]:
                out.append(Violation(
                    "tree-malformed",
                    f"{label}: tree {j} moves no messages at all"))
                continue
            # broadcast edges must be exactly the reversed reduce edges
            down = {(p, c) for c, p in parent.items()}
            bc = {(bsrc[c], c) for c in bwave}
            if down != bc:
                diff = sorted(down ^ bc)[:3]
                out.append(Violation(
                    "phase-mismatch",
                    f"{label}: tree {j}: broadcast edges are not the "
                    f"reversed reduce edges (mismatched: {diff})"))
            # edge-disjointness across trees (the EDST property itself)
            for c, p in parent.items():
                e = canon(c, p)
                if e in edge_owner and edge_owner[e] != j:
                    out.append(Violation(
                        "edge-disjointness",
                        f"{label}: trees {edge_owner[e]} and {j} both route "
                        f"over physical link {e}"))
                edge_owner.setdefault(e, j)
        if clean:
            max_depth = max(max_depth, max(depth_of.values(), default=0))
        # happens-before over the recovered structure
        children: dict = {}
        for c, p in parent.items():
            children.setdefault(p, []).append(c)
        for c, p in parent.items():
            if c not in rwave:
                continue
            for g in children.get(c, ()):
                if g in rwave and rwave[g] >= rwave[c]:
                    out.append(Violation(
                        "happens-before",
                        f"{label}: tree {j}: reduce {c}->{p} rides wave "
                        f"{rwave[c]} but child {g}'s reduce only lands in "
                        f"wave {rwave[g]}"))
        for c in bwave:
            p = bsrc[c]
            if root is not None and p == root:
                for g in children.get(root, ()):
                    if g in rwave and rwave[g] >= bwave[c]:
                        out.append(Violation(
                            "happens-before",
                            f"{label}: tree {j}: broadcast {p}->{c} rides "
                            f"wave {bwave[c]} but the root's total needs "
                            f"{g}'s reduce (wave {rwave[g]})"))
            elif p in bwave and bwave[p] >= bwave[c]:
                out.append(Violation(
                    "happens-before",
                    f"{label}: tree {j}: broadcast {p}->{c} rides wave "
                    f"{bwave[c]} but {p} only receives the total in wave "
                    f"{bwave[p]}"))
    if (not hb_only and spec_depth is not None and k > 0
            and len(out) == structural):
        bad = (spec_depth < max_depth) if depth_is_min \
            else (max_depth != spec_depth)
        if bad:
            rel = "is below" if depth_is_min else "disagrees with"
            out.append(Violation(
                "depth-mismatch",
                f"{label}: spec.depth={spec_depth} {rel} the deepest "
                f"recovered tree depth {max_depth}"))


# ---------------------------------------------------------------------------
# chunk-engine table scans (message recovery from the routing tables)
# ---------------------------------------------------------------------------

def _scan_pipelined(spec, waves, label: str, out: list):
    msgs = []
    k = spec.k
    for w, wv in enumerate(waves):
        _scan_perm(w, wv.perm, label, out)
        for s, d in wv.perm:
            j = int(wv.send_row[s])
            if not 0 <= j < k:
                out.append(Violation(
                    "spec-meta",
                    f"{label}[{w}]: sender {s} ships row {j}, outside "
                    f"0..{k - 1}"))
                continue
            rows_r = np.nonzero(wv.reduce_flag[:, d])[0]
            rows_b = np.nonzero(wv.bcast_flag[:, d])[0]
            nflag = len(rows_r) + len(rows_b)
            if nflag == 0:
                out.append(Violation(
                    "recv-dropped",
                    f"{label}[{w}]: arrival {s}->{d} (row {j}) has no "
                    f"landing flag at vertex {d}"))
                continue
            if nflag > 1:
                out.append(Violation(
                    "table-stray",
                    f"{label}[{w}]: vertex {d} is flagged {nflag} times for "
                    "a single arrival"))
            jj = int(rows_r[0]) if len(rows_r) else int(rows_b[0])
            kind = REDUCE if len(rows_r) else BCAST
            if jj != j:
                out.append(Violation(
                    "row-misroute",
                    f"{label}[{w}]: arrival {s}->{d} carries row {j} but "
                    f"lands in row {jj}"))
                continue
            msgs.append((w, j, kind, s, d))
        flagged = set(np.nonzero(wv.reduce_flag.any(axis=0)
                                 | wv.bcast_flag.any(axis=0))[0].tolist())
        stray = flagged - {d for _, d in wv.perm}
        for d in sorted(stray):
            out.append(Violation(
                "table-stray",
                f"{label}[{w}]: vertex {d} is flagged to receive but no "
                "message arrives"))
        # executor-specialization metadata
        expect_rows = tuple(sorted({int(wv.send_row[s])
                                    for s, _ in wv.perm}))
        if tuple(wv.rows) != expect_rows:
            out.append(Violation(
                "table-stray",
                f"{label}[{w}]: rows metadata {wv.rows} but senders ship "
                f"rows {expect_rows}"))
        expect_sole = (expect_rows[0]
                       if len(expect_rows) == 1 and not wv.bcast_flag.any()
                       else -1)
        if wv.sole_add != expect_sole:
            out.append(Violation(
                "table-stray",
                f"{label}[{w}]: sole_add={wv.sole_add} but the tables imply "
                f"{expect_sole} (executors skip masking on sole_add waves)"))
    return msgs


def _scan_fused(spec, out: list):
    msgs = []
    rounds = ([(REDUCE, r) for r in spec.reduce_rounds]
              + [(BCAST, r) for r in spec.bcast_rounds])
    for w, (kind, rnd) in enumerate(rounds):
        _scan_perm(w, rnd.perm, "rounds", out)
        for s, d in rnd.perm:
            j = int(rnd.send_row[s])
            if not 0 <= j < spec.k:
                out.append(Violation(
                    "spec-meta",
                    f"rounds[{w}]: sender {s} ships row {j}, outside "
                    f"0..{spec.k - 1}"))
                continue
            if not rnd.recv_flag[d]:
                out.append(Violation(
                    "recv-dropped",
                    f"rounds[{w}]: arrival {s}->{d} (row {j}) but vertex "
                    f"{d}'s recv_flag is off"))
                continue
            jj = int(rnd.recv_row[d])
            if jj != j:
                out.append(Violation(
                    "row-misroute",
                    f"rounds[{w}]: arrival {s}->{d} carries row {j} but "
                    f"lands in row {jj}"))
                continue
            msgs.append((w, j, kind, s, d))
        stray = (set(np.nonzero(rnd.recv_flag)[0].tolist())
                 - {d for _, d in rnd.perm})
        for d in sorted(stray):
            out.append(Violation(
                "table-stray",
                f"rounds[{w}]: vertex {d} is flagged to receive but no "
                "message arrives"))
    return msgs


def _scan_per_tree(spec, out: list):
    msgs = []
    w = 0
    for j, tp in enumerate(spec.trees):
        for perm in tp.reduce_rounds:
            _scan_perm(w, perm, f"tree{j}.reduce", out)
            msgs.extend((w, j, REDUCE, s, d) for s, d in perm)
            w += 1
        dst_tables = tp.bcast_dst or (None,) * len(tp.bcast_rounds)
        if len(dst_tables) != len(tp.bcast_rounds):
            out.append(Violation(
                "table-stray",
                f"tree{j}: {len(dst_tables)} bcast_dst tables for "
                f"{len(tp.bcast_rounds)} broadcast rounds"))
            dst_tables = (None,) * len(tp.bcast_rounds)
        for perm, table in zip(tp.bcast_rounds, dst_tables):
            _scan_perm(w, perm, f"tree{j}.bcast", out)
            if table is not None:
                dsts = {d for _, d in perm}
                flagged = {v for v, f in enumerate(table) if f}
                for d in sorted(dsts - flagged):
                    out.append(Violation(
                        "recv-dropped",
                        f"tree{j}.bcast[{w}]: arrival at {d} but its "
                        "bcast_dst flag is off"))
                for d in sorted(flagged - dsts):
                    out.append(Violation(
                        "table-stray",
                        f"tree{j}.bcast[{w}]: vertex {d} flagged in "
                        "bcast_dst but no message arrives"))
            msgs.extend((w, j, BCAST, s, d) for s, d in perm)
            w += 1
    return msgs


# ---------------------------------------------------------------------------
# striped engine
# ---------------------------------------------------------------------------

def _scan_striped_program(spec, waves, expected_kinds, label: str,
                          out: list):
    """Per-wave scan of one striped program; returns messages with their
    slot windows: (wave, tree, kind, src, dst, slot, nslot)."""
    msgs = []
    n, k = spec.n, spec.k
    for w, wv in enumerate(waves):
        _scan_perm(w, wv.perm, label, out)
        if wv.op not in (REDUCE, BCAST):
            out.append(Violation(
                "op-mixed", f"{label}[{w}]: op {wv.op} is neither "
                "accumulate (REDUCE) nor overwrite (BCAST)"))
        if sorted(wv.perm) != sorted((s, d) for _, _, s, d in wv.msgs):
            out.append(Violation(
                "table-stray",
                f"{label}[{w}]: perm and msgs disagree on which links the "
                "wave uses"))
        for j, kind, s, d in wv.msgs:
            if not 0 <= j < k:
                out.append(Violation(
                    "spec-meta",
                    f"{label}[{w}]: message names tree {j}, outside "
                    f"0..{k - 1}"))
                continue
            if kind not in expected_kinds:
                out.append(Violation(
                    "op-mixed",
                    f"{label}[{w}]: kind {_KIND_NAME.get(kind, kind)} does "
                    "not belong to this program"))
                continue
            if _striped_op((j, kind, s, d)) != wv.op:
                out.append(Violation(
                    "op-mixed",
                    f"{label}[{w}]: {_KIND_NAME[kind]} message {s}->{d} in "
                    "a wave whose op disagrees (executor applies ONE op per "
                    "wave)"))
            if int(wv.send_tree[s]) != j or int(wv.recv_tree[d]) != j:
                out.append(Violation(
                    "row-misroute",
                    f"{label}[{w}]: message {s}->{d} belongs to tree {j} "
                    f"but the tables say send_tree={int(wv.send_tree[s])} "
                    f"recv_tree={int(wv.recv_tree[d])}"))
                continue
            swin = (int(wv.send_slot[s]), int(wv.send_nslot[s]))
            rwin = (int(wv.recv_slot[d]), int(wv.recv_nslot[d]))
            if swin != rwin:
                out.append(Violation(
                    "row-misroute",
                    f"{label}[{w}]: message {s}->{d} ships window {swin} "
                    f"but the receiver expects {rwin}"))
                continue
            if not 0 < swin[1] <= n or not 0 <= swin[0] < n:
                out.append(Violation(
                    "stripe-conservation",
                    f"{label}[{w}]: window {swin} of {s}->{d} is not a "
                    f"non-empty circular window mod {n}"))
                continue
            msgs.append((w, j, kind, s, d, swin[0], swin[1]))
    return msgs


def _check_striped_structure(spec, msgs, expected_kinds, label: str,
                             out: list) -> None:
    n, k = spec.n, spec.k
    up_kind = _UP_OF[expected_kinds]
    structural = len(out)
    max_depth = 0
    all_clean = True
    edge_owner: dict = {}
    for j in range(k):
        mine = [m for m in msgs if m[1] == j]
        up = [(s, d) for _, _, kind, s, d, _, _ in mine if kind == up_kind]
        parent, root, depth_of, clean = _recover_parent(
            n, up, j, label, out)
        all_clean = all_clean and clean
        # edge-disjointness across trees (the EDST property itself)
        for c, p in parent.items():
            e = canon(c, p)
            if e in edge_owner and edge_owner[e] != j:
                out.append(Violation(
                    "edge-disjointness",
                    f"{label}: trees {edge_owner[e]} and {j} both route "
                    f"over physical link {e}"))
            edge_owner.setdefault(e, j)
        if clean:
            max_depth = max(max_depth, max(depth_of.values(), default=0))
        # spec.trees metadata must agree with the recovered routing
        if clean and j < len(spec.trees):
            st = spec.trees[j]
            meta = {c: int(st.parent[c]) for c in range(n)
                    if st.parent[c] >= 0}
            if meta != parent or st.root != root:
                out.append(Violation(
                    "tree-malformed",
                    f"{label}: tree {j}: spec.trees metadata disagrees "
                    "with the tree recovered from the routing tables"))
        children: dict = {}
        for c, p in parent.items():
            children.setdefault(p, []).append(c)
        # recovered subtree sizes (leaves first)
        size = {v: 1 for v in range(n)}
        if clean:
            for v in sorted(depth_of, key=lambda v: -depth_of[v]):
                if v in parent:
                    size[parent[v]] += size[v]
        # per-edge kind multiplicity, direction, and windows
        per_edge: dict = {}
        wave_of: dict = {}
        for w, _, kind, s, d, lo, ns in mine:
            c = s if kind in (RS_UP, AG_UP) else d
            p_end = d if kind in (RS_UP, AG_UP) else s
            slot = per_edge.setdefault(c, {})
            if kind in slot:
                out.append(Violation(
                    "message-conservation",
                    f"{label}: tree {j}: edge of child {c} carries "
                    f"{_KIND_NAME[kind]} twice"))
                continue
            slot[kind] = (lo, ns, p_end)
            wave_of[(c, kind)] = w
        for c, slot in per_edge.items():
            missing = expected_kinds - set(slot)
            if missing:
                out.append(Violation(
                    "message-conservation",
                    f"{label}: tree {j}: edge of child {c} is missing "
                    f"{sorted(_KIND_NAME[m] for m in missing)}"))
                continue
            for kind, (lo, ns, p_end) in slot.items():
                if c in parent and p_end != parent[c]:
                    out.append(Violation(
                        "phase-mismatch",
                        f"{label}: tree {j}: {_KIND_NAME[kind]} of child "
                        f"{c} runs to/from {p_end}, not its parent "
                        f"{parent[c]}"))
            below = [slot[kd][:2] for kd in slot if kd in _BELOW_KINDS]
            above = [slot[kd][:2] for kd in slot if kd not in _BELOW_KINDS]
            if len(set(below)) > 1 or len(set(above)) > 1:
                out.append(Violation(
                    "stripe-conservation",
                    f"{label}: tree {j}: child {c}'s reduce-scatter and "
                    f"allgather windows disagree (below {below}, above "
                    f"{above})"))
                continue
            if below and above:
                (blo, bns), (alo, ans) = below[0], above[0]
                if (bns + ans != n or (blo + bns) % n != alo
                        or (alo + ans) % n != blo):
                    out.append(Violation(
                        "stripe-conservation",
                        f"{label}: tree {j}: windows below={below[0]} "
                        f"above={above[0]} of child {c} are not circular "
                        f"complements mod {n} -- some owner slot crosses "
                        "the edge twice or never"))
            if below and clean and below[0][1] != size.get(c, -1):
                out.append(Violation(
                    "stripe-conservation",
                    f"{label}: tree {j}: child {c}'s below-window holds "
                    f"{below[0][1]} slots but its recovered subtree has "
                    f"{size.get(c)}"))
            # the ownership table (DFS preorder slots) executors cut own
            # stripes with must agree with the routed windows: a preorder
            # subtree owns exactly [pre[c], pre[c]+size[c]) -- a stale
            # table kept across a re-striping failover silently
            # mis-slices every owner cut
            if below and clean and j < len(spec.trees):
                st = spec.trees[j]
                if (int(st.pre[c]) != below[0][0]
                        or int(st.size[c]) != below[0][1]):
                    out.append(Violation(
                        "stale-ownership",
                        f"{label}: tree {j}: ownership table says child "
                        f"{c} owns slots [{int(st.pre[c])}, "
                        f"+{int(st.size[c])}) but the routed below-window "
                        f"is {below[0]} -- stripe table is stale w.r.t. "
                        "the routing (re-stripe after failover)"))
        # child windows nest inside the parent's below window
        if all(len(slot) == len(expected_kinds) for slot in
               per_edge.values()):
            for c, p in parent.items():
                if p == root or p not in per_edge or c not in per_edge:
                    continue
                cb = [per_edge[c][kd][:2] for kd in per_edge[c]
                      if kd in _BELOW_KINDS]
                pb = [per_edge[p][kd][:2] for kd in per_edge[p]
                      if kd in _BELOW_KINDS]
                if not cb or not pb:
                    continue
                (clo, cns), (plo, pns) = cb[0], pb[0]
                if (clo - plo) % n + cns > pns:
                    out.append(Violation(
                        "stripe-conservation",
                        f"{label}: tree {j}: child {c}'s below window "
                        f"{cb[0]} escapes its parent {p}'s subtree window "
                        f"{pb[0]}"))
        # happens-before: the striped dependency rules, re-derived
        ru = {c: wave_of.get((c, RS_UP)) for c in parent}
        rd = {c: wave_of.get((c, RS_DOWN)) for c in parent}
        au = {c: wave_of.get((c, AG_UP)) for c in parent}
        ad = {c: wave_of.get((c, AG_DOWN)) for c in parent}

        def _need(later, earlier, what):
            if later is not None and earlier is not None \
                    and earlier >= later:
                out.append(Violation(
                    "happens-before",
                    f"{label}: tree {j}: {what} (waves {later} vs "
                    f"{earlier})"))

        for c, p in parent.items():
            kids_c = children.get(c, ())
            kids_p = children.get(p, ())
            for g in kids_c:
                _need(ru.get(c), ru.get(g),
                      f"RS_UP({c}->{p}) before child {g}'s RS_UP")
                _need(au.get(c), au.get(g),
                      f"AG_UP({c}->{p}) before child {g}'s AG_UP")
                _need(au.get(c), ru.get(g),
                      f"AG_UP({c}->{p}) before child {g}'s RS_UP")
            _need(au.get(c), rd.get(c),
                  f"AG_UP({c}->{p}) before its own RS_DOWN")
            for g in kids_p:
                if g != c:
                    _need(rd.get(c), ru.get(g),
                          f"RS_DOWN({p}->{c}) before sibling {g}'s RS_UP")
                    _need(ad.get(c), au.get(g),
                          f"AG_DOWN({p}->{c}) before sibling {g}'s AG_UP")
                _need(ad.get(c), ru.get(g),
                      f"AG_DOWN({p}->{c}) before {p}'s child {g}'s RS_UP")
            if p in parent:             # p is not the root
                _need(rd.get(c), rd.get(p),
                      f"RS_DOWN({p}->{c}) before {p}'s own RS_DOWN")
                _need(ad.get(c), rd.get(p),
                      f"AG_DOWN({p}->{c}) before {p}'s own RS_DOWN")
                _need(ad.get(c), ad.get(p),
                      f"AG_DOWN({p}->{c}) before {p}'s own AG_DOWN")
    if (len(out) == structural and all_clean and k > 0
            and expected_kinds is _ALL_STRIPED_KINDS
            and max_depth != spec.depth):
        out.append(Violation(
            "depth-mismatch",
            f"{label}: spec.depth={spec.depth} but the deepest recovered "
            f"tree has depth {max_depth}"))


# ---------------------------------------------------------------------------
# verify_spec / assert_valid
# ---------------------------------------------------------------------------

def verify_spec(spec, level: str = "full") -> VerifyReport:
    """Statically verify one compiled spec (any engine).  ``"cheap"``
    runs the single-pass wave scans + the link-race check; ``"full"``
    adds tree recovery, happens-before, edge-disjointness, stripe
    conservation and depth.  Never executes an engine or the
    simulator."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    engine = engine_of(spec)
    out: list = []
    if spec.k == 0:                    # the empty (pass-through) program
        return VerifyReport(engine, spec.n, 0, level, 0, 0, out)
    if not spec.axes:
        out.append(Violation("spec-meta", "spec.axes is empty"))

    if engine == "pipelined":
        msgs = _scan_pipelined(spec, spec.waves, "waves", out)
        qmsgs = _scan_pipelined(spec, spec.q8_waves, "q8_waves", out)
        _check_link_race(msgs, "waves", out)
        _check_link_race(qmsgs, "q8_waves", out)
        b = spec.q8_boundary
        for w, _, kind, s, d in qmsgs:
            if (kind == BCAST) != (w >= b):
                out.append(Violation(
                    "op-mixed",
                    f"q8_waves[{w}]: {_KIND_NAME[kind]} message {s}->{d} on "
                    f"the wrong side of q8_boundary={b} (the pack-once "
                    "point)"))
        if sorted(m[1:] for m in msgs) != sorted(m[1:] for m in qmsgs):
            out.append(Violation(
                "message-conservation",
                "q8_waves move a different message multiset than waves"))
        if level == "full":
            _check_trees(spec.n, spec.k, msgs, spec.depth, "waves", out)
            _check_trees(spec.n, spec.k, qmsgs, None, "q8_waves", out,
                         hb_only=True)
        nmsgs, nwaves = len(msgs), len(spec.waves)

    elif engine == "fused":
        msgs = _scan_fused(spec, out)
        _check_link_race(msgs, "rounds", out)
        if level == "full":
            _check_trees(spec.n, spec.k, msgs, spec.depth, "rounds", out)
        nmsgs = len(msgs)
        nwaves = len(spec.reduce_rounds) + len(spec.bcast_rounds)

    elif engine == "per_tree":
        msgs = _scan_per_tree(spec, out)
        _check_link_race(msgs, "rounds", out)
        if level == "full":
            _check_trees(spec.n, spec.k, msgs, spec.depth, "rounds", out,
                         depth_is_min=True)
        nmsgs = len(msgs)
        nwaves = sum(len(t.reduce_rounds) + len(t.bcast_rounds)
                     for t in spec.trees)

    else:                              # striped
        programs = (("waves", spec.waves, _ALL_STRIPED_KINDS),
                    ("rs_waves", spec.rs_waves, _RS_KINDS),
                    ("ag_waves", spec.ag_waves, _AG_KINDS))
        scanned = {}
        for label, waves, kinds in programs:
            scanned[label] = _scan_striped_program(spec, waves, kinds,
                                                   label, out)
            if level == "full":
                _check_striped_structure(spec, scanned[label], kinds,
                                         label, out)
        comp = sorted(m[1:5] for m in scanned["waves"])
        split = sorted([m[1:5] for m in scanned["rs_waves"]]
                       + [m[1:5] for m in scanned["ag_waves"]])
        if comp != split:
            out.append(Violation(
                "message-conservation",
                "the composed program moves a different message multiset "
                "than rs_waves + ag_waves"))
        nmsgs, nwaves = len(scanned["waves"]), len(spec.waves)

    return VerifyReport(engine, spec.n, spec.k, level, nmsgs, nwaves, out)


def assert_valid(spec, level: str = "full", context: str = "") -> VerifyReport:
    """:func:`verify_spec`, raising :class:`SpecVerificationError` on any
    violation.  The spec compilers call this under their ``verify=``
    flag, so an illegal schedule is rejected at build time."""
    report = verify_spec(spec, level=level)
    if not report.ok:
        raise SpecVerificationError(report, context)
    return report


# ---------------------------------------------------------------------------
# contract builder (the lint_hlo side of the verifier)
# ---------------------------------------------------------------------------

def hlo_contract_for(spec, quantize: bool = False,
                     m: int | None = None,
                     phase: str = "composed") -> HloContract:
    """The HLO contract a correct executor compile of ``spec`` satisfies,
    enforced by :func:`repro_torch.analysis.hlo.lint_hlo` on a
    recording of the run's fabric ``ppermute`` calls:

      * exactly one ``collective-permute`` site per wave, *flat in the
        segment count* (S segments stream through each wave's one site);
      * quantized programs put at most ``bcast-wave-count`` f32 wire
        sites in the HLO (reduce wires are int8; broadcast wires are the
        bit-packed f32 lanes), and every f32 wire is the *packed* width,
        never a full ``mrow``-element row.

    ``phase`` (striped engine only) selects which program the executor
    compiled: ``"composed"`` (``striped_allreduce``), ``"rs"`` / ``"ag"``
    (the standalone reduce-scatter / allgather), or ``"zero1"`` (one
    zero1 train step: gradient reduce-scatter + param allgather, no
    composed program) -- the contract under which the zero1 step proves
    it issues strictly fewer collective waves than the composed
    allreduce.
    """
    engine = engine_of(spec)
    if phase != "composed" and engine != "striped":
        raise ValueError(f"phase={phase!r} needs the striped engine; "
                         f"{engine} compiles only the composed program")
    ppermutes: int | None
    max_f32_sites = None
    max_f32_wire = None
    if engine == "pipelined":
        ppermutes = len(spec.q8_waves) if quantize else len(spec.waves)
        if quantize:
            max_f32_sites = len(spec.q8_waves) - spec.q8_boundary
    elif engine == "fused":
        ppermutes = spec.num_collectives
        if quantize:
            max_f32_sites = len(spec.bcast_rounds)
    elif engine == "per_tree":
        ppermutes = sum(len(t.reduce_rounds) + len(t.bcast_rounds)
                        for t in spec.trees)
        if quantize:
            max_f32_sites = sum(len(t.bcast_rounds) for t in spec.trees)
    else:                              # striped: f32 payload sites, and
        # a ``phase`` choosing the compiled program (see docstring);
        # binding to a payload size m drops empty-stripe waves exactly
        # like the executor does
        bound = striped_tables(spec, m) if m else None

        def _nwaves(name):
            return len(getattr(bound if m else spec, name))

        if phase == "composed":
            ppermutes = _nwaves("waves")
        elif phase == "rs":
            ppermutes = _nwaves("rs_waves")
        elif phase == "ag":
            ppermutes = _nwaves("ag_waves")
        elif phase == "zero1":
            ppermutes = _nwaves("rs_waves") + _nwaves("ag_waves")
        else:
            raise ValueError(f"phase {phase!r} not in "
                             "('composed', 'rs', 'ag', 'zero1')")
        quantize = False
    if quantize and m is not None and spec.k:
        mrow = -(-m // spec.k)
        # the packed broadcast wire is ceil(mrow/4) f32 lanes + 1 scale
        # lane (+1 headroom for segment padding); a full f32 row (mrow
        # elements, the codec-off wire) must exceed this cap
        max_f32_wire = -(-mrow // 4) + 2
    return HloContract(ppermutes=ppermutes, max_f32_sites=max_f32_sites,
                       max_f32_wire_elems=max_f32_wire)


# ---------------------------------------------------------------------------
# CLI: engines x paper topologies (the CI gate)
# ---------------------------------------------------------------------------

PAPER_TOPOLOGIES = ("torus4x4", "hyperx4x4", "slimfly_q5",
                    "polarstar_er3_qr5", "bundlefly_q4_a5")


def _topology_case(label: str):
    """(star product, explicit-E set or None) for one paper topology."""
    from ..core import topologies as topo
    if label == "torus4x4":
        return topo.device_topology((4, 4)), None
    if label == "hyperx4x4":
        return topo.hyperx([4, 4]), None
    if label == "slimfly_q5":
        return topo.slimfly(5), None
    if label == "polarstar_er3_qr5":
        return topo.polarstar(3, "qr", 5), None
    if label == "bundlefly_q4_a5":
        return topo.bundlefly(4, 5), topo.edst_set_for(topo.slimfly(4))
    raise KeyError(f"unknown topology {label!r}; known: "
                   f"{', '.join(PAPER_TOPOLOGIES)}")


def _schedule_for(label: str):
    from ..core.collectives import allreduce_schedule
    from ..core.edst_star import star_edsts
    sp, es = _topology_case(label)
    res = star_edsts(sp, Es=es) if es is not None else star_edsts(sp)
    return allreduce_schedule(sp.product().n, res.trees)


def _compile_specs(sched, engines):
    """engine -> compiled spec.  Compiled with ``verify=False``: the CLI
    runs :func:`verify_spec` itself."""
    from ..core.collectives import (fused_spec_from_schedule,
                                    pipelined_spec_from_schedule,
                                    striped_spec_from_schedule)
    axes = ("data",)
    specs: dict = {}
    for eng in engines:
        if eng == "fused":
            specs[eng] = fused_spec_from_schedule(sched, axes, verify=False)
        elif eng == "pipelined":
            specs[eng] = pipelined_spec_from_schedule(sched, axes,
                                                      verify=False)
        elif eng == "striped":
            specs[eng] = striped_spec_from_schedule(sched, axes,
                                                    verify=False)
        elif eng == "per_tree":
            from ..dist.tree_allreduce import spec_from_schedule
            specs[eng] = spec_from_schedule(sched, axes, verify=False)
    return specs


def _simulate_case(label: str, sched, specs) -> list:
    """The dynamic gate: replay every engine's program through the NumPy
    packet simulators."""
    from ..core.collectives import (simulate_allreduce,
                                    simulate_striped_program,
                                    simulate_wave_program, striped_tables)
    failures = []
    n, k = sched.n, sched.k
    rng = np.random.RandomState(sum(map(ord, label)))
    d = 8 * k + 3                          # uneven on purpose
    vals = rng.randn(n, d)

    sim = simulate_allreduce(sched, rng.randn(n, 8 * k))
    if not sim.ok:
        failures.append("per_tree: wrong sums")
    if sim.max_link_load != 1:
        failures.append(f"per_tree: link load {sim.max_link_load} != 1")

    pspec = specs.get("pipelined")
    if pspec is not None:
        for segments in (1, 4):
            for q in (False, True):
                sim = simulate_wave_program(pspec, vals, segments,
                                            quantized=q)
                if not sim.ok:
                    failures.append(
                        f"pipelined: wrong sums (S={segments} q={q})")
                if sim.max_link_load != 1:
                    failures.append(
                        f"pipelined: directed-link load "
                        f"{sim.max_link_load} != 1 (S={segments} q={q})")

    sspec = specs.get("striped")
    if sspec is not None:
        ssim = simulate_striped_program(sspec, vals)
        bound = striped_tables(sspec, d)
        if not ssim.ok:
            failures.append("striped: wrong sums")
        if not ssim.stripes_ok:
            failures.append("striped: per-stripe conservation violated")
        for bw, wire in zip(bound.waves, ssim.wire_elems):
            if wire != int(bw.recv_len.max()):
                failures.append("striped: wave wire != max window length")
            if wire > bound.smax * (n - 1):
                failures.append(
                    f"striped: wire {wire} exceeds ceil(m/n)*(n-1) slots")
        if bound.mrow >= n and ssim.max_wire >= bound.mrow:
            failures.append(
                f"striped: max wire {ssim.max_wire} not < m {bound.mrow}")
    return failures


_STATS_NBYTES = 64 * 1024 * 1024


def _stats_row(label: str, eng: str, spec, rep: VerifyReport) -> dict:
    """One ``--stats`` table row: schedule-quality numbers for a verified
    spec -- wave count, tree depth, and the :class:`CostModel` makespan of
    a 64 MiB allreduce (the same score the anytime schedule search
    minimizes, so greedy/search/composed runs are directly comparable in
    CI logs)."""
    from ..core.collectives import CostModel
    cm = CostModel()
    makespan = None
    try:
        if eng == "striped":
            makespan = cm.striped_allreduce(_STATS_NBYTES, spec)
        elif eng == "pipelined":
            makespan = cm.pipelined_allreduce(
                _STATS_NBYTES, spec, cm.best_segments(_STATS_NBYTES, spec))
    except Exception:                  # cost model is advisory here
        makespan = None
    return {"topology": label, "engine": eng, "n": rep.n, "k": rep.k,
            "depth": getattr(spec, "depth", None), "waves": rep.waves,
            "messages": rep.messages, "makespan_us": makespan}


def _print_stats(rows) -> None:
    """Aligned waves/depth/makespan table (the ``--stats`` output)."""
    heads = ("topology", "engine", "n", "k", "depth", "waves", "messages",
             "makespan_us")
    table = [heads]
    for r in rows:
        ms = r["makespan_us"]
        table.append((r["topology"], r["engine"], str(r["n"]), str(r["k"]),
                      "-" if r["depth"] is None else str(r["depth"]),
                      str(r["waves"]), str(r["messages"]),
                      "-" if ms is None else f"{ms * 1e6:.1f}"))
    width = [max(len(row[c]) for row in table) for c in range(len(heads))]
    print("\nschedule stats (CostModel, 64 MiB allreduce):")
    for i, row in enumerate(table):
        print("  " + "  ".join(cell.ljust(w)
                               for cell, w in zip(row, width)).rstrip())
        if i == 0:
            print("  " + "  ".join("-" * w for w in width))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description="Static wave-program verification of every compiled "
                    "EDST allreduce engine on the paper topologies "
                    "(no engine execution).")
    p.add_argument("--engines", default=None,
                   help="comma-separated subset of " + ",".join(ENGINES))
    p.add_argument("--all-engines", action="store_true",
                   help="verify every engine (the default when --engines "
                        "is omitted)")
    p.add_argument("--topologies", default="paper5",
                   help="'paper5' or a comma-separated subset of "
                        + ",".join(PAPER_TOPOLOGIES))
    p.add_argument("--level", default="full", choices=LEVELS)
    p.add_argument("--simulate", action="store_true",
                   help="additionally replay the NumPy packet "
                        "simulators (the dynamic gate)")
    p.add_argument("--stats", action="store_true",
                   help="print a waves/depth/makespan table per engine x "
                        "topology after verification (CostModel at 64 MiB; "
                        "the CI-log compile summary)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="also write a predicted Perfetto (Chrome trace "
                        "event JSON) file per verified engine x topology "
                        "into DIR -- the --stats table rendered as a "
                        "timeline (same 64 MiB CostModel timings)")
    args = p.parse_args(argv)

    engines = (ENGINES if args.engines is None or args.all_engines
               else tuple(e.strip() for e in args.engines.split(",") if e))
    for e in engines:
        if e not in ENGINES:
            p.error(f"unknown engine {e!r}; known: {', '.join(ENGINES)}")
    labels = (PAPER_TOPOLOGIES if args.topologies == "paper5"
              else tuple(t.strip() for t in args.topologies.split(",") if t))

    t0 = time.perf_counter()
    bad = 0
    stats_rows = []
    for label in labels:
        sched = _schedule_for(label)
        specs = _compile_specs(sched, engines)
        for eng in engines:
            spec = specs[eng]
            rep = verify_spec(spec, level=args.level)
            status = "ok" if rep.ok else "FAIL"
            print(f"verify/{label}/{eng}: {status} "
                  f"({rep.messages} messages, {rep.waves} waves)"
                  + "".join(f"\n  - {v}" for v in rep.violations[:20]))
            bad += len(rep.violations)
            if args.stats:
                stats_rows.append(_stats_row(label, eng, spec, rep))
            if args.trace:
                import os

                from ..telemetry import trace as ttrace
                os.makedirs(args.trace, exist_ok=True)
                path = os.path.join(args.trace, f"trace_{label}_{eng}.json")
                ttrace.write_trace(path, ttrace.trace_spec(
                    spec, nbytes=_STATS_NBYTES, label=f"{label}/{eng}"))
                print(f"  trace -> {path}")
        if args.simulate:
            failures = _simulate_case(label, sched, specs)
            status = "ok" if not failures else "FAIL"
            print(f"simulate/{label}: {status}"
                  + "".join(f"\n  - {f}" for f in failures))
            bad += len(failures)
    if args.stats and stats_rows:
        _print_stats(stats_rows)
    dt = time.perf_counter() - t0
    if bad:
        print(f"\n{bad} invariant violation(s) in {dt:.2f}s")
        return 1
    print(f"\nall engines statically legal on all requested topologies "
          f"({dt:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
