"""Multi-tree allreduce schedules from EDST sets (paper Sec. 1.1 payoff):
the port's copy of the reference's ``repro.core.collectives``.

A set of k EDSTs yields k contention-free reduction/broadcast trees: the
gradient is split into k chunks, chunk j is reduced leaves->root along tree j
and broadcast root->leaves, all trees concurrently.  Edge-disjointness
guarantees no two trees ever use the same physical link (asserted).

Every compiled form the port's engines run lives here: the round-major
fused program (:class:`FusedAllreduceSpec`), the list-scheduled pipelined
wave program (:class:`PipelinedAllreduceSpec`) and the striped
reduce-scatter / allgather program (:class:`StripedCollectiveSpec`), their
packet-level simulators, the per-wave wire bytes and the alpha-beta
:class:`CostModel`.  Every compiler hands its freshly built program to
the static verifier (:mod:`repro_torch.analysis.verify`, through
:func:`verify_compiled_spec`) before caching it, at the level its
``verify=`` flag resolves to: ``"cheap"`` by default, ``"full"`` under
the tests.  A spec that fails raises
:class:`~repro_torch.analysis.verify.SpecVerificationError`.
"""
from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass, field

import numpy as np

from .csr import tree_center
from .graph import canon, tree_depth_levels

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# chunk apportioning (the canonical largest-remainder striping helper)
# ---------------------------------------------------------------------------

def chunk_sizes(total: int, fractions) -> tuple:
    """Apportion ``total`` elements by largest-remainder rounding; sizes sum
    exactly to ``total`` (a retired tree -- fraction 0 -- gets 0).

    The single canonical striping helper: per-tree chunk widths
    (``repro_torch.dist.tree_allreduce``), weighted fault re-striping
    (the reference's ``repro.dist.fault``), and per-vertex owner stripes
    (:func:`striped_spec_from_schedule` / :func:`striped_tables`) all
    apportion through here, so every layer rounds identically."""
    raw = [f * total for f in fractions]
    sizes = [int(np.floor(r)) for r in raw]
    leftover = total - sum(sizes)
    order = sorted(range(len(raw)), key=lambda i: (sizes[i] - raw[i], i))
    for i in order[:leftover]:
        sizes[i] += 1
    return tuple(sizes)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@dataclass
class TreeSchedule:
    """Reduce/broadcast rounds for one spanning tree."""
    n: int
    root: int
    tree: frozenset
    reduce_rounds: list   # list[rounds]; each round = list[(src, dst)]
    bcast_rounds: list

    @property
    def depth(self) -> int:
        return len(self.bcast_rounds)


def tree_schedule(n: int, tree, root: int | None = None) -> TreeSchedule:
    tree = frozenset(canon(*e) for e in tree)
    root = _best_root(n, tree) if root is None else root
    levels = tree_depth_levels(tree, root)  # levels[d] = [(parent, child)]
    reduce_rounds = [[(c, p) for p, c in lvl] for lvl in reversed(levels)]
    bcast_rounds = [list(lvl) for lvl in levels]
    return TreeSchedule(n, root, tree, reduce_rounds, bcast_rounds)


def _best_root(n: int, tree) -> int:
    """Root minimizing tree depth (a tree center), O(n) via the CSR
    double-BFS in :mod:`repro_torch.core.csr` (three sweeps instead of the old
    every-vertex probe, which was O(n^2) and dominated schedule compiles
    on >= 1000-node fabrics)."""
    return tree_center(n, tree)[0]


def _best_root_probe(n: int, tree) -> int:
    """The historical O(n^2) every-vertex BFS probe.  Kept as the
    regression oracle for :func:`_best_root` (identical roots/depths are
    asserted in tests) and as the baseline timed by
    ``benchmarks/allreduce_bench.py``."""
    best, best_d = 0, 10**9
    adj: dict = {}
    for u, v in tree:
        adj.setdefault(u, []).append(v)
        adj.setdefault(v, []).append(u)

    def depth_from(r):
        seen = {r}
        d, frontier = 0, [r]
        while frontier:
            nxt = []
            for u in frontier:
                for w in adj.get(u, ()):
                    if w not in seen:
                        seen.add(w)
                        nxt.append(w)
            if nxt:
                d += 1
            frontier = nxt
        return d

    for r in range(n):
        d = depth_from(r)
        if d < best_d:
            best, best_d = r, d
    return best


@dataclass
class AllreduceSchedule:
    """k concurrent tree schedules (one chunk per tree)."""
    n: int
    trees: list  # list[TreeSchedule]

    @property
    def k(self) -> int:
        return len(self.trees)

    @property
    def depth(self) -> int:
        return max(t.depth for t in self.trees)

    def check_contention_free(self) -> bool:
        """No physical link is used by two different trees (EDST property)."""
        seen = set()
        for ts in self.trees:
            for e in ts.tree:
                if e in seen:
                    return False
                seen.add(e)
        return True

    def global_rounds(self, phase: str):
        """Round r = union of every tree's round-r messages, tagged by tree."""
        rounds_attr = "reduce_rounds" if phase == "reduce" else "bcast_rounds"
        nrounds = max(len(getattr(t, rounds_attr)) for t in self.trees)
        out = []
        for r in range(nrounds):
            msgs = []
            for j, ts in enumerate(self.trees):
                rr = getattr(ts, rounds_attr)
                if r < len(rr):
                    msgs.extend((j, s, d) for s, d in rr[r])
            out.append(msgs)
        return out


#: Wave-assembly strategies the spec compilers accept: ``"greedy"`` is the
#: flat critical-path list schedule, ``"search"`` the seeded hillclimb of
#: :mod:`repro_torch.core.schedule_search` (never worse than greedy), and
#: ``"composed"`` the near-linear compositional assembly of
#: :mod:`repro_torch.core.product_schedule`.
SCHEDULES = ("greedy", "search", "composed")


def allreduce_schedule(n: int, trees, roots=None) -> AllreduceSchedule:
    """Build the k-tree schedule.  ``roots`` may be explicit root ids,
    ``None`` (depth-minimizing tree centers via :func:`_best_root`), or
    ``"search"`` -- the strict-improvement root search of
    :mod:`repro_torch.core.schedule_search`, which only replaces a center root
    when a candidate is strictly shallower (so searched roots are never
    deeper than :func:`_best_root`)."""
    if isinstance(roots, str):
        if roots != "search":
            raise ValueError(f"roots={roots!r}: expected explicit roots, "
                             "None, or 'search'")
        from .schedule_search import search_roots
        roots = search_roots(n, trees)
    roots = roots or [None] * len(trees)
    sched = AllreduceSchedule(n, [tree_schedule(n, t, r)
                                  for t, r in zip(trees, roots)])
    assert sched.check_contention_free(), "trees share a link"
    return sched


# ---------------------------------------------------------------------------
# compile-time static verification (repro_torch.analysis.verify)
# ---------------------------------------------------------------------------
#
# Every spec compiler takes a ``verify=`` flag and hands the freshly
# built program to the static verifier BEFORE caching it, so an illegal
# schedule (e.g. a schedule-search candidate with two trees on one link,
# or a rescale's repack of an irregular residual fabric) is rejected at
# build time, not discovered as wrong sums at step time.  ``verify=None``
# resolves through the ``REPRO_VERIFY_SPECS`` environment variable
# ("off" | "cheap" | "full"); production defaults to the O(messages)
# cheap assert mode, the tests export REPRO_VERIFY_SPECS=full (see
# tests/conftest.py).


def _resolve_verify(verify) -> str:
    """``verify`` level: ``None`` reads ``REPRO_VERIFY_SPECS`` (default
    ``"cheap"``); ``True``/``False`` mean
    ``"full"``/``"off"``.  ``"full"`` also turns on the list scheduler's
    self-check."""
    if verify is None:
        mode = os.environ.get("REPRO_VERIFY_SPECS", "cheap")
    elif verify is True:
        mode = "full"
    elif verify is False:
        mode = "off"
    else:
        mode = verify
    if mode not in ("off", "cheap", "full"):
        raise ValueError(
            f"verify must be one of off/cheap/full (or bool/None), "
            f"got {mode!r}")
    return mode


def verify_compiled_spec(spec, verify=None, context: str = ""):
    """Run the static verifier (:mod:`repro_torch.analysis.verify`) on a
    compiled spec at the resolved level; raises
    :class:`repro_torch.analysis.verify.SpecVerificationError` on
    violations.  Imported lazily: the verifier itself imports this
    module."""
    mode = _resolve_verify(verify)
    if mode == "off":
        return spec
    from ..analysis.verify import assert_valid
    assert_valid(spec, level=mode, context=context)
    return spec


# ---------------------------------------------------------------------------
# fused global-round program (the executor-facing compiled form)
# ---------------------------------------------------------------------------
#
# ``AllreduceSchedule`` is tree-major: tree j's rounds, then tree j+1's.
# Executed literally that is sum-of-all-trees serial hops.  The fused form
# is round-major: global round r carries round r of EVERY tree, and each
# global round is split into the fewest ppermute-legal waves (unique
# sources and destinations per wave) over the *union* of the trees'
# messages.  Because a wave's sources are unique, every sender ships
# exactly one tree's chunk, so one ppermute moves several trees' traffic
# at once -- the wire bytes are unchanged (edge-disjointness: each message
# still crosses its own link) but the collective count drops from
# sum-of-trees rounds to depth-of-deepest-tree waves.
#
# Per wave the compiler precomputes (n,)-shaped NumPy tables consumed by
# ``repro_torch.dist.tree_allreduce.fused_tree_allreduce`` at call time:
# ``send_row[v]`` = which chunk row vertex v ships, ``recv_row[v]`` /
# ``recv_flag[v]`` = where an arriving payload lands (and whether one
# arrives at all).  Nothing is rebuilt per call.

@dataclass(frozen=True, eq=False)
class FusedRound:
    """One ppermute-legal wave of a global round."""
    perm: tuple            # ((src, dst), ...) unique srcs, unique dsts
    send_row: np.ndarray   # (n,) int32: chunk row vertex v sends
    recv_row: np.ndarray   # (n,) int32: chunk row an arrival lands in
    recv_flag: np.ndarray  # (n,) bool: does vertex v receive this wave


@dataclass(frozen=True, eq=False)
class FusedAllreduceSpec:
    """Round-major allreduce program with precomputed per-wave tables.

    Hash/equality follow ``key`` (fabric size, axis names, rooted tree
    sets), so two compiles of the same (topology, axes) -- which
    :func:`fused_spec_from_schedule` also caches to the same object --
    never retrace a jitted executor that takes the spec statically.
    """
    n: int
    k: int
    axes: tuple            # mesh axis names the allreduce runs over
    depth: int             # deepest tree's level count
    reduce_rounds: tuple   # tuple[FusedRound], deepest level first
    bcast_rounds: tuple    # tuple[FusedRound], root level first
    key: tuple

    @property
    def num_collectives(self) -> int:
        """ppermutes one allreduce issues (1 per wave, quantized or not)."""
        return len(self.reduce_rounds) + len(self.bcast_rounds)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return (isinstance(other, FusedAllreduceSpec)
                and self.key == other.key)


def _split_tagged(msgs):
    """Greedily split one global round's (tree, src, dst) messages into
    waves with unique sources and unique destinations (ppermute-legal)."""
    out, remaining = [], list(msgs)
    while remaining:
        srcs, dsts, taken, rest = set(), set(), [], []
        for m in remaining:
            _, s, d = m
            if s in srcs or d in dsts:
                rest.append(m)
            else:
                srcs.add(s)
                dsts.add(d)
                taken.append(m)
        out.append(taken)
        remaining = rest
    return out


def _fused_round(n: int, taken) -> FusedRound:
    send_row = np.zeros(n, np.int32)
    recv_row = np.zeros(n, np.int32)
    recv_flag = np.zeros(n, bool)
    perm = []
    for j, s, d in taken:
        perm.append((s, d))
        send_row[s] = j
        recv_row[d] = j
        recv_flag[d] = True
    return FusedRound(tuple(perm), send_row, recv_row, recv_flag)


def _sched_key(sched: AllreduceSchedule, axes: tuple) -> tuple:
    return (sched.n, axes, tuple((ts.root, ts.tree) for ts in sched.trees))


_FUSED_CACHE: dict = {}


def _routed_spec(engine: str, sched, axes, verify, schedule: str,
                 seed: int):
    """Dispatch a ``schedule=`` strategy (:data:`SCHEDULES`) to its
    compiler: ``"search"`` to :mod:`repro_torch.core.schedule_search`,
    ``"composed"`` to the ASAP assemblers of
    :mod:`repro_torch.core.product_schedule` (lazy imports -- both modules
    import this one).  Returns ``None`` for ``"greedy"``: the caller
    runs its own list-scheduled body."""
    if schedule == "greedy":
        return None
    if schedule == "search":
        from . import schedule_search as ss
        fn = {"fused": ss.search_fused_spec,
              "pipelined": ss.search_pipelined_spec,
              "striped": ss.search_striped_spec}[engine]
        return fn(sched, axes, verify, seed=seed)
    if schedule == "composed":
        from . import product_schedule as ps
        fn = {"fused": ps.asap_fused_spec,
              "pipelined": ps.asap_pipelined_spec,
              "striped": ps.asap_striped_spec}[engine]
        return fn(sched, axes, verify)
    raise ValueError(f"schedule={schedule!r}: expected one of {SCHEDULES}")


def fused_spec_from_schedule(sched: AllreduceSchedule,
                             axis_names,
                             verify=None, schedule: str = "greedy",
                             seed: int = 0) -> FusedAllreduceSpec:
    """Compile an :class:`AllreduceSchedule` into the round-major
    :class:`FusedAllreduceSpec`.  Compiles are cached by (fabric, rooted
    trees, axes): repeated calls for the same topology return the *same*
    object.  Fresh compiles are statically verified per ``verify=`` (see
    :func:`verify_compiled_spec`) before entering the cache; cache hits
    re-verify only on an explicit truthy ``verify``.  ``schedule`` picks
    the wave-assembly strategy (:data:`SCHEDULES`); non-greedy strategies
    append their tag (and ``seed``, for search) to the spec key, so each
    strategy keeps its own stable spec identity."""
    axes = tuple(axis_names)
    routed = _routed_spec("fused", sched, axes, verify, schedule, seed)
    if routed is not None:
        return routed
    key = _sched_key(sched, axes)
    hit = _FUSED_CACHE.get(key)
    if hit is not None:
        if verify:
            verify_compiled_spec(hit, verify, "fused_spec_from_schedule")
        return hit
    phases = {}
    for phase in ("reduce", "bcast"):
        rounds = []
        for msgs in sched.global_rounds(phase):
            rounds.extend(_fused_round(sched.n, wave)
                          for wave in _split_tagged(msgs))
        phases[phase] = tuple(rounds)
    spec = FusedAllreduceSpec(n=sched.n, k=sched.k, axes=axes,
                              depth=sched.depth,
                              reduce_rounds=phases["reduce"],
                              bcast_rounds=phases["bcast"], key=key)
    verify_compiled_spec(spec, verify, "fused_spec_from_schedule")
    _FUSED_CACHE[key] = spec
    return spec


def empty_fused_spec(n: int, axis_names) -> FusedAllreduceSpec:
    """The k=0 program (no trees survive): executor passes data through."""
    axes = tuple(axis_names)
    return FusedAllreduceSpec(n=n, k=0, axes=axes, depth=0,
                              reduce_rounds=(), bcast_rounds=(),
                              key=(n, axes, ()))


# ---------------------------------------------------------------------------
# pipelined wave program (the segment-streaming compiled form)
# ---------------------------------------------------------------------------
#
# The fused form above is round-major but still *round-aligned*: global
# round r waits for every tree's round r-1, fan-in overflow waves stall
# whole rounds, and the broadcast phase cannot start until the deepest
# tree's reduce finishes.  The pipelined compiler drops the round
# alignment entirely: it builds the dependency DAG over every message of
# every tree and BOTH phases (a reduce send needs the sender's subtree
# complete; a broadcast send needs the sender to hold the final total)
# and list-schedules the DAG into the fewest ppermute-legal waves,
# longest-critical-path messages first.  A shallow tree's broadcast
# overlaps a deep tree's reduce tail, fan-in spill rides later waves, and
# the wave count drops from `2 * depth * k`-ish to within a couple of the
# DAG critical path (22 -> 12 on the 4x4 torus with k=2).
#
# The wave list doubles as the *pipeline stage* sequence: wave w only
# depends on waves < w, so payload segment s can run wave w while segment
# s+1 runs wave w-1.  Streaming S segments costs `waves + S - 1` steps of
# `m/S`-sized hops -- the classic `2*depth*m  ->  (2*depth + S - 1)*(m/S)`
# bandwidth-optimal tree pipeline -- and the executor's scan over the
# step index keeps HLO size and trace time independent of S.
#
# Quantized programs are compiled phase-separated (`q8_waves`): int8 and
# f32 payloads cannot share one ppermute, and a reduce/broadcast boundary
# lets the executor quantize each tree's total ONCE and forward the
# packed bytes down the tree instead of re-coding every hop.

REDUCE, BCAST = 1, 2


@dataclass(frozen=True, eq=False)
class PipeWave:
    """One ppermute-legal wave of the pipelined program.

    ``send_row[v]`` names the chunk row vertex v ships (senders only);
    ``reduce_flag[j, v]`` / ``bcast_flag[j, v]`` say whether the arrival
    at v accumulates into / overwrites row j.  ``rows`` is the static
    set of distinct sender rows (executors specialize on its size) and
    ``sole_add`` marks waves whose every arrival accumulates into one
    row -- there the executor may skip masking entirely, because
    ``ppermute`` hands devices nobody sent to a zero payload.
    """
    perm: tuple            # ((src, dst), ...) unique srcs, unique dsts
    send_row: np.ndarray   # (n,) int32
    reduce_flag: np.ndarray  # (k, n) bool
    bcast_flag: np.ndarray   # (k, n) bool
    rows: tuple            # distinct sender chunk rows, sorted
    sole_add: int          # row index if pure single-row reduce wave, else -1

    @property
    def has_bcast(self) -> bool:
        return bool(self.bcast_flag.any())


@dataclass(frozen=True, eq=False)
class PipelinedAllreduceSpec:
    """List-scheduled wave program with segment-pipelining metadata.

    ``waves`` is the phase-mixed program (fewest waves; the f32 engine);
    ``q8_waves`` the phase-separated program for quantized wires with
    ``q8_boundary`` marking the first broadcast wave (the pack-once
    point).  The stacked ``(R, n)`` tables (``send_rows`` / ``dst_table``
    / ``recv_rows`` / ``recv_kind``) are the canonical compiled form
    consumed by the packet simulator and the table-driven tests; the
    executors read the per-wave views.  Hash/equality follow ``key`` so
    cached recompiles never retrace a jitted executor.
    """
    n: int
    k: int
    axes: tuple            # mesh axis names the allreduce runs over
    depth: int             # deepest tree's level count
    waves: tuple           # tuple[PipeWave], dependency order
    q8_waves: tuple        # tuple[PipeWave], reduce waves then bcast waves
    q8_boundary: int       # index of the first bcast wave in q8_waves
    key: tuple

    @property
    def num_collectives(self) -> int:
        """ppermutes one unpipelined (S=1) allreduce issues."""
        return len(self.waves)

    def steps(self, segments: int) -> int:
        """Pipeline steps to stream ``segments`` payload segments."""
        return len(self.waves) + segments - 1

    def _stack(self, waves):
        r, n = len(waves), self.n
        send = np.zeros((r, n), np.int32)
        dst = np.full((r, n), -1, np.int32)
        recv = np.full((r, n), -1, np.int32)
        kind = np.zeros((r, n), np.int8)
        for w, wv in enumerate(waves):
            send[w] = wv.send_row
            for s, d in wv.perm:
                dst[w, s] = d
            for j in range(self.k):
                recv[w, wv.reduce_flag[j]] = j
                kind[w, wv.reduce_flag[j]] = REDUCE
                recv[w, wv.bcast_flag[j]] = j
                kind[w, wv.bcast_flag[j]] = BCAST
        return send, dst, recv, kind

    @property
    def tables(self):
        """Stacked ``(R, n)`` tables of the mixed program:
        ``(send_rows, dst_table, recv_rows, recv_kind)``."""
        return self._stack(self.waves)

    @property
    def q8_tables(self):
        return self._stack(self.q8_waves)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return (isinstance(other, PipelinedAllreduceSpec)
                and self.key == other.key)


def _message_dag(sched: AllreduceSchedule):
    """Every (tree, kind, src, dst) message with its dependency set.

    reduce (c -> p) needs c's children's reduce messages delivered;
    broadcast (p -> c) needs p to hold tree j's final total: every reduce
    message into the root when p is the root, else the broadcast into p.
    Messages are appended children-before-parents (reduce) and
    roots-before-leaves (broadcast), so ids topologically order the DAG.
    """
    msgs, deps = [], []
    for j, ts in enumerate(sched.trees):
        children: dict = {}
        for lvl in ts.bcast_rounds:
            for p, c in lvl:
                children.setdefault(p, []).append(c)
        rid: dict = {}
        for lvl in ts.reduce_rounds:        # deepest level first
            for c, p in lvl:
                deps.append(frozenset(rid[x] for x in children.get(c, ())))
                rid[c] = len(msgs)
                msgs.append((j, REDUCE, c, p))
        into_root = frozenset(rid[x] for x in children.get(ts.root, ()))
        bid: dict = {}
        for lvl in ts.bcast_rounds:         # root level first
            for p, c in lvl:
                deps.append(into_root if p == ts.root else frozenset({bid[p]}))
                bid[c] = len(msgs)
                msgs.append((j, BCAST, p, c))
    return msgs, deps


def _list_schedule(msgs, deps, kinds=None, op_of=None, verify=False,
                   priority=None):
    """Greedy list scheduling of the message DAG into ppermute-legal
    waves (unique sources AND destinations per wave), critical-path
    height first.  A message becomes ready only once every dependency is
    delivered in a strictly earlier wave, which is exactly what the
    executors need: a sender's local value is complete by the time its
    wave reads it.  ``kinds`` restricts a pass to a subset of message
    kinds (the quantized program schedules reduce and broadcast
    separately).  ``op_of`` (message -> op class) keeps each wave
    homogeneous in arrival semantics: the striped program mixes
    accumulate (reduce-scatter) and overwrite (allgather) messages in
    one DAG, but an executor wave must apply a single op.  ``verify``
    re-checks the emitted waves against the scheduling contract (every
    selected message exactly once, per-wave ppermute legality, every
    dependency in a strictly earlier wave) -- the compilers enable it
    under full-level spec verification so schedule-search candidates
    cannot smuggle an illegal wave past the greedy selector."""
    ids = [i for i in range(len(msgs)) if kinds is None or msgs[i][1] in kinds]
    chosen = set(ids)
    dependents: dict = {i: [] for i in ids}
    for i in ids:
        for d in deps[i]:
            if d in chosen:
                dependents[d].append(i)
    height = {i: 0 for i in ids}
    for i in reversed(ids):                 # ids are topologically ordered
        for dep in dependents[i]:
            height[i] = max(height[i], height[dep] + 1)
    done: set = set(i for i in range(len(msgs)) if i not in chosen)
    pending = set(ids)
    waves = []
    while pending:
        if priority is None:
            ready = sorted((i for i in pending if deps[i] <= done),
                           key=lambda i: (-height[i], msgs[i][0], msgs[i][2]))
        else:
            ready = sorted((i for i in pending if deps[i] <= done),
                           key=lambda i: (-height[i], priority[i]))
        if op_of is not None and ready:
            wave_op = op_of(msgs[ready[0]])
            ready = [i for i in ready if op_of(msgs[i]) == wave_op]
        srcs, dsts, take = set(), set(), []
        for i in ready:
            _, _, s, d = msgs[i]
            if s not in srcs and d not in dsts:
                srcs.add(s)
                dsts.add(d)
                take.append(i)
        assert take, "list scheduler stalled (cyclic message DAG?)"
        waves.append(take)
        pending -= set(take)
        done |= set(take)
    if verify:
        _check_list_schedule(msgs, deps, ids, waves, op_of)
    return waves


def _check_list_schedule(msgs, deps, ids, waves, op_of=None) -> None:
    """Self-check of a list-scheduled wave program (see
    :func:`_list_schedule`); raises ``ValueError`` on any breach."""
    scheduled = [i for take in waves for i in take]
    if sorted(scheduled) != sorted(ids):
        raise ValueError("list schedule drops or duplicates messages")
    wave_of = {i: w for w, take in enumerate(waves) for i in take}
    chosen = set(ids)
    for w, take in enumerate(waves):
        srcs = [msgs[i][2] for i in take]
        dsts = [msgs[i][3] for i in take]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"list schedule wave {w} is not ppermute-legal")
        if op_of is not None and len({op_of(msgs[i]) for i in take}) > 1:
            raise ValueError(f"list schedule wave {w} mixes arrival ops")
        for i in take:
            late = [d for d in deps[i] if d in chosen and wave_of[d] >= w]
            if late:
                raise ValueError(
                    f"list schedule wave {w}: message {msgs[i]} precedes "
                    f"its dependency {msgs[late[0]]}")


def _pipe_wave(n: int, k: int, msgs, take) -> PipeWave:
    send_row = np.zeros(n, np.int32)
    rflag = np.zeros((k, n), bool)
    bflag = np.zeros((k, n), bool)
    perm, rows = [], set()
    for i in take:
        j, kind, s, d = msgs[i]
        perm.append((s, d))
        send_row[s] = j
        rows.add(j)
        (rflag if kind == REDUCE else bflag)[j, d] = True
    sole = min(rows) if len(rows) == 1 and not bflag.any() else -1
    return PipeWave(tuple(perm), send_row, rflag, bflag,
                    tuple(sorted(rows)), sole)


_PIPE_CACHE: dict = {}


def pipelined_spec_from_schedule(sched: AllreduceSchedule,
                                 axis_names,
                                 verify=None, schedule: str = "greedy",
                                 seed: int = 0) -> PipelinedAllreduceSpec:
    """Compile an :class:`AllreduceSchedule` into the list-scheduled
    :class:`PipelinedAllreduceSpec`.  Cached by (fabric, rooted trees,
    axes) like :func:`fused_spec_from_schedule`: recompiles return the
    identical object.  Fresh compiles are statically verified per
    ``verify=`` before caching (full level also self-checks the list
    scheduler's waves).  ``schedule`` picks the wave-assembly strategy
    (:data:`SCHEDULES`); non-greedy strategies carry their own spec-key
    tag."""
    axes = tuple(axis_names)
    routed = _routed_spec("pipelined", sched, axes, verify, schedule, seed)
    if routed is not None:
        return routed
    key = (*_sched_key(sched, axes), "pipelined")
    hit = _PIPE_CACHE.get(key)
    if hit is not None:
        if verify:
            verify_compiled_spec(hit, verify, "pipelined_spec_from_schedule")
        return hit
    deep = _resolve_verify(verify) == "full"
    msgs, deps = _message_dag(sched)
    n, k = sched.n, sched.k
    waves = tuple(_pipe_wave(n, k, msgs, take)
                  for take in _list_schedule(msgs, deps, verify=deep))
    red = [_pipe_wave(n, k, msgs, take)
           for take in _list_schedule(msgs, deps, kinds={REDUCE},
                                      verify=deep)]
    bc = [_pipe_wave(n, k, msgs, take)
          for take in _list_schedule(msgs, deps, kinds={BCAST},
                                     verify=deep)]
    spec = PipelinedAllreduceSpec(n=n, k=k, axes=axes, depth=sched.depth,
                                  waves=waves, q8_waves=tuple(red + bc),
                                  q8_boundary=len(red), key=key)
    verify_compiled_spec(spec, verify, "pipelined_spec_from_schedule")
    _PIPE_CACHE[key] = spec
    return spec


def empty_pipelined_spec(n: int, axis_names) -> PipelinedAllreduceSpec:
    """The k=0 program (no trees survive): executor passes data through."""
    axes = tuple(axis_names)
    return PipelinedAllreduceSpec(n=n, k=0, axes=axes, depth=0, waves=(),
                                  q8_waves=(), q8_boundary=0,
                                  key=(n, axes, (), "pipelined"))


def simulate_wave_program(spec, values: np.ndarray,
                          segments: int = 1, quantized: bool = False
                          ) -> SimResult:
    """Packet-level replay of the compiled wave program with the payload
    split into ``segments`` pipeline segments: at step t wave w moves
    segment ``t - w``, exactly as the scan executor does.  Checks that
    every vertex ends with the global sum and that no wave reuses a
    source or destination.  ``quantized`` replays ``q8_waves``.

    A :class:`StripedCollectiveSpec` dispatches to
    :func:`simulate_striped_program` (which additionally checks
    per-stripe conservation); striped programs carry stripe-sized
    payloads instead of segment-streaming, so ``segments``/``quantized``
    do not change their routing and are ignored."""
    if isinstance(spec, StripedCollectiveSpec):
        return simulate_striped_program(spec, values)
    n, d = values.shape
    k = spec.k
    if k == 0:
        return SimResult(False, 0, 0, {})
    assert n == spec.n
    m = -(-d // k)
    msub = -(-m // segments)
    padded = np.pad(values.astype(np.float64), ((0, 0), (0, k * m - d))) \
        .reshape(n, k, m)
    state = np.zeros((n, k, segments * msub))
    state[:, :, :m] = padded
    expected = padded.sum(0)
    waves = spec.q8_waves if quantized else spec.waves
    link_bytes: dict = {}
    max_load = 0
    steps = len(waves) + segments - 1
    for t in range(steps):
        staged = []
        loads: dict = {}
        for w, wv in enumerate(waves):
            seg = t - w
            if not 0 <= seg < segments:
                continue
            srcs = [s for s, _ in wv.perm]
            dsts = [d_ for _, d_ in wv.perm]
            assert len(set(srcs)) == len(srcs), "wave reuses a source"
            assert len(set(dsts)) == len(dsts), "wave reuses a destination"
            lo, hi = seg * msub, (seg + 1) * msub
            for s, d_ in wv.perm:
                row = int(wv.send_row[s])
                payload = state[s, row, lo:hi].copy()
                kind = (REDUCE if wv.reduce_flag[row, d_] else BCAST)
                staged.append((d_, row, lo, hi, kind, payload))
                # phase-mixed waves may drive one undirected link in both
                # directions at once (full duplex), so loads are DIRECTED
                loads[(s, d_)] = loads.get((s, d_), 0) + 1
                link_bytes[(s, d_)] = link_bytes.get((s, d_), 0) + (hi - lo)
        for d_, row, lo, hi, kind, payload in staged:
            if kind == REDUCE:
                state[d_, row, lo:hi] += payload
            else:
                state[d_, row, lo:hi] = payload
        if loads:
            max_load = max(max_load, max(loads.values()))
    final = state[:, :, :m]
    ok = bool(np.allclose(final, expected[None]))
    return SimResult(ok, steps, max_load, link_bytes)


# ---------------------------------------------------------------------------
# striped reduce-scatter / allgather wave program
# ---------------------------------------------------------------------------
#
# Every engine above ships the full m-sized chunk along every tree edge.
# The k EDSTs expose k edge-disjoint pathways precisely so collectives can
# *stripe*: assign each vertex an owner stripe per tree and restructure
# each tree's traffic as reduce-scatter (partial sums flow both rootward
# and leafward, but an edge only carries the stripes owned on the far
# side of it) followed by allgather (finished stripes fan back out, a
# pure gather -- arrivals overwrite, nothing accumulates).
#
# Owner stripes follow the tree's DFS *preorder*: the vertex with
# preorder index i owns stripe slot i, so every subtree is a contiguous
# slot interval [pre(c), pre(c)+size(c)) and its complement is a
# contiguous interval of the *circular* slot space.  Each message is then
# one circular window:
#
#   RS_UP   c -> p  carries the `above` window (slots owned outside
#                   subtree(c)): subtree(c)'s partial sums flow rootward;
#   RS_DOWN p -> c  carries the `below` window (slots owned inside
#                   subtree(c)): everyone else's partials flow leafward;
#   AG_UP   c -> p  carries `below`: finished subtree stripes gather up;
#   AG_DOWN p -> c  carries `above`: the rest of the totals gather down.
#
# After RS every vertex holds the finished total of its OWN stripe; after
# AG every vertex holds all of them.  An edge's window always excludes at
# least one slot (a subtree and its complement are both non-empty), so
# per-wave wire bytes drop from m to <= ceil(m/n) * slots-in-window --
# the bound `simulate_striped_program` checks.
#
# The four kinds of every tree form ONE dependency DAG and are
# list-scheduled together (op-homogeneous waves: reduce-scatter arrivals
# accumulate, allgather arrivals overwrite), so a shallow tree's gather
# overlaps a deep tree's scatter tail exactly like the pipelined engine.
# Standalone `rs_waves` / `ag_waves` programs (each phase's sub-DAG) back
# the first-class tree_reduce_scatter / tree_allgather collectives in
# ``repro_torch.dist.striped``.
#
# The spec is m-independent: windows are compiled in SLOT units, and
# :func:`striped_tables` binds them to element offsets for a concrete
# payload via the canonical largest-remainder :func:`chunk_sizes` (the
# same helper that apportions per-tree chunk widths, so weighted fault
# re-striping composes with ownership for free).

RS_UP, RS_DOWN, AG_UP, AG_DOWN = 11, 12, 13, 14
_RS_KINDS = frozenset({RS_UP, RS_DOWN})


def _striped_op(msg):
    """Arrival semantics class: reduce-scatter accumulates, allgather
    overwrites (REDUCE/BCAST reuse the executor-facing constants)."""
    return REDUCE if msg[1] in _RS_KINDS else BCAST


@dataclass(frozen=True, eq=False)
class StripedTree:
    """One tree's ownership structure: DFS preorder slot per vertex."""
    root: int
    pre: np.ndarray      # (n,) int32: owner slot (preorder index) of v
    size: np.ndarray     # (n,) int32: subtree size of v
    parent: np.ndarray   # (n,) int32: parent vertex, -1 at the root


@dataclass(frozen=True, eq=False)
class StripedWave:
    """One ppermute-legal, op-homogeneous wave in SLOT units.

    ``send_slot[v]`` / ``send_nslot[v]`` name sender v's circular slot
    window (mod n) inside tree ``send_tree[v]``'s chunk; the ``recv_*``
    tables the matching window an arrival lands in (``recv_nslot[v]`` = 0
    when v receives nothing).  ``op`` is REDUCE (accumulate) or BCAST
    (overwrite) for every arrival of the wave."""
    perm: tuple            # ((src, dst), ...) unique srcs, unique dsts
    op: int                # REDUCE | BCAST
    msgs: tuple            # ((tree, kind, src, dst), ...)
    send_tree: np.ndarray  # (n,) int32
    send_slot: np.ndarray  # (n,) int32
    send_nslot: np.ndarray  # (n,) int32
    recv_tree: np.ndarray  # (n,) int32
    recv_slot: np.ndarray  # (n,) int32
    recv_nslot: np.ndarray  # (n,) int32


@dataclass(frozen=True, eq=False)
class StripedCollectiveSpec:
    """Compiled striped reduce-scatter / allgather program.

    ``waves`` is the composed allreduce (reduce-scatter ∘ allgather, one
    DAG); ``rs_waves`` / ``ag_waves`` the standalone phase programs.
    Windows are in slot units -- :func:`striped_tables` binds a concrete
    payload size (and optional per-tree fractions).  Hash/equality follow
    ``key`` so cached recompiles never retrace a jitted executor."""
    n: int
    k: int
    axes: tuple            # mesh axis names the collective runs over
    depth: int             # deepest tree's level count
    trees: tuple           # tuple[StripedTree]
    waves: tuple           # tuple[StripedWave], composed program
    rs_waves: tuple        # tuple[StripedWave], reduce-scatter only
    ag_waves: tuple        # tuple[StripedWave], allgather only
    key: tuple

    @property
    def num_collectives(self) -> int:
        """ppermutes one composed striped allreduce issues."""
        return len(self.waves)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return (isinstance(other, StripedCollectiveSpec)
                and self.key == other.key)


def _striped_tree(n: int, ts: TreeSchedule) -> StripedTree:
    children: dict = {}
    for lvl in ts.bcast_rounds:
        for p, c in lvl:
            children.setdefault(p, []).append(c)
    pre = np.full(n, -1, np.int32)
    size = np.ones(n, np.int32)
    parent = np.full(n, -1, np.int32)
    order = []
    stack = [ts.root]
    while stack:                      # iterative DFS preorder
        v = stack.pop()
        pre[v] = len(order)
        order.append(v)
        for c in reversed(children.get(v, ())):
            parent[c] = v
            stack.append(c)
    for v in reversed(order):         # subtree sizes, leaves first
        if parent[v] >= 0:
            size[parent[v]] += size[v]
    assert len(order) == n, "tree does not span the fabric"
    return StripedTree(ts.root, pre, size, parent)


def _striped_dag(sched: AllreduceSchedule, trees):
    """Messages + dependency sets of the striped program.

    For edge (c, p) of tree j (c the child):
      RS_UP(c)   needs RS_UP(g -> c) for every child g of c;
      RS_DOWN(c) needs RS_UP(g -> p) for every OTHER child g of p, plus
                 RS_DOWN(p) unless p is the root (the window it ships --
                 subtree(c)'s slots -- must hold every contribution from
                 outside subtree(c) first);
      AG_UP(c)   needs c's reduce-scatter complete (all RS_UP into c and
                 RS_DOWN(c): c's own stripe is finished) plus AG_UP(g)
                 for every child (their subtree totals ride along);
      AG_DOWN(c) needs every RS_UP into p (p's own stripe finished),
                 AG_UP(g -> p) for every other child, and -- unless p is
                 the root -- RS_DOWN(p) and AG_DOWN(p).
    Message ids are appended in dependency-safe order per tree, keeping
    the topological-order contract of :func:`_list_schedule`."""
    msgs, deps = [], []
    for j, st in enumerate(trees):
        children: dict = {}
        for v in range(sched.n):
            if st.parent[v] >= 0:
                children.setdefault(int(st.parent[v]), []).append(v)
        for v in children:            # DFS preorder == slot order per level
            children[v].sort(key=lambda c: st.pre[c])
        rup: dict = {}
        rdn: dict = {}
        aup: dict = {}
        # down-kinds walk roots-before-leaves (decreasing subtree size:
        # every proper ancestor has a strictly larger subtree), up-kinds
        # children-before-parents (increasing) -- keeps appended ids
        # topologically ordered
        by_depth = sorted((v for v in range(sched.n) if st.parent[v] >= 0),
                          key=lambda v: -int(st.size[v]))
        for v in sorted(range(sched.n), key=lambda v: int(st.size[v])):
            if st.parent[v] < 0:
                continue
            deps.append(frozenset(rup[g] for g in children.get(v, ())))
            rup[v] = len(msgs)
            msgs.append((j, RS_UP, v, int(st.parent[v])))
        # RS_DOWN roots-before-leaves: walk by decreasing subtree size
        for v in by_depth:
            p = int(st.parent[v])
            d = {rup[g] for g in children.get(p, ()) if g != v}
            if st.parent[p] >= 0:
                d.add(rdn[p])
            deps.append(frozenset(d))
            rdn[v] = len(msgs)
            msgs.append((j, RS_DOWN, p, v))
        # AG_UP children-before-parents
        for v in sorted(range(sched.n), key=lambda v: int(st.size[v])):
            if st.parent[v] < 0:
                continue
            d = {rup[g] for g in children.get(v, ())} | {rdn[v]}
            d |= {aup[g] for g in children.get(v, ())}
            deps.append(frozenset(d))
            aup[v] = len(msgs)
            msgs.append((j, AG_UP, v, int(st.parent[v])))
        # AG_DOWN roots-before-leaves
        adn: dict = {}
        for v in by_depth:
            p = int(st.parent[v])
            d = {rup[g] for g in children.get(p, ())}
            d |= {aup[g] for g in children.get(p, ()) if g != v}
            if st.parent[p] >= 0:
                d |= {rdn[p], adn[p]}
            deps.append(frozenset(d))
            adn[v] = len(msgs)
            msgs.append((j, AG_DOWN, p, v))
    return msgs, deps


def _striped_wave(n: int, msgs, take, trees) -> StripedWave:
    send_tree = np.zeros(n, np.int32)
    send_slot = np.zeros(n, np.int32)
    send_nslot = np.zeros(n, np.int32)
    recv_tree = np.zeros(n, np.int32)
    recv_slot = np.zeros(n, np.int32)
    recv_nslot = np.zeros(n, np.int32)
    perm, taken = [], []
    op = _striped_op(msgs[take[0]])
    for i in take:
        j, kind, s, d = msgs[i]
        assert _striped_op(msgs[i]) == op, "mixed-op striped wave"
        st = trees[j]
        c = s if kind in (RS_UP, AG_UP) else d      # the child endpoint
        below = (int(st.pre[c]), int(st.size[c]))
        above = ((int(st.pre[c]) + int(st.size[c])) % n, n - int(st.size[c]))
        slot, nslot = below if kind in (RS_DOWN, AG_UP) else above
        perm.append((s, d))
        taken.append((j, kind, s, d))
        send_tree[s], send_slot[s], send_nslot[s] = j, slot, nslot
        recv_tree[d], recv_slot[d], recv_nslot[d] = j, slot, nslot
    return StripedWave(tuple(perm), op, tuple(taken), send_tree, send_slot,
                       send_nslot, recv_tree, recv_slot, recv_nslot)


_STRIPED_CACHE: dict = {}


def striped_spec_from_schedule(sched: AllreduceSchedule,
                               axis_names,
                               verify=None, schedule: str = "greedy",
                               seed: int = 0) -> StripedCollectiveSpec:
    """Compile an :class:`AllreduceSchedule` into the striped
    reduce-scatter / allgather :class:`StripedCollectiveSpec`.  Cached by
    (fabric, rooted trees, axes) like the other spec compilers:
    recompiles return the identical object.  Fresh compiles are
    statically verified per ``verify=`` before caching (full level also
    self-checks the list scheduler's waves).  ``schedule`` picks the
    wave-assembly strategy (:data:`SCHEDULES`); non-greedy strategies
    carry their own spec-key tag."""
    axes = tuple(axis_names)
    routed = _routed_spec("striped", sched, axes, verify, schedule, seed)
    if routed is not None:
        return routed
    key = (*_sched_key(sched, axes), "striped")
    hit = _STRIPED_CACHE.get(key)
    if hit is not None:
        if verify:
            verify_compiled_spec(hit, verify, "striped_spec_from_schedule")
        return hit
    deep = _resolve_verify(verify) == "full"
    trees = tuple(_striped_tree(sched.n, ts) for ts in sched.trees)
    msgs, deps = _striped_dag(sched, trees)
    n = sched.n

    def waves_of(kinds=None):
        return tuple(_striped_wave(n, msgs, take, trees)
                     for take in _list_schedule(msgs, deps, kinds=kinds,
                                                op_of=_striped_op,
                                                verify=deep))

    spec = StripedCollectiveSpec(
        n=n, k=sched.k, axes=axes, depth=sched.depth, trees=trees,
        waves=waves_of(), rs_waves=waves_of(_RS_KINDS),
        ag_waves=waves_of(frozenset({AG_UP, AG_DOWN})), key=key)
    verify_compiled_spec(spec, verify, "striped_spec_from_schedule")
    _STRIPED_CACHE[key] = spec
    return spec


def empty_striped_spec(n: int, axis_names) -> StripedCollectiveSpec:
    """The k=0 program (no trees survive): executor passes data through."""
    axes = tuple(axis_names)
    return StripedCollectiveSpec(n=n, k=0, axes=axes, depth=0, trees=(),
                                 waves=(), rs_waves=(), ag_waves=(),
                                 key=(n, axes, (), "striped"))


# -- binding slot windows to a concrete payload -----------------------------

@dataclass(frozen=True, eq=False)
class BoundStripedWave:
    """A :class:`StripedWave` with slot windows resolved to element
    offsets for one payload size.  ``wire`` is the wave's padded wire
    length (max true window length over its surviving messages);
    windows are circular mod ``mrow``."""
    perm: tuple
    op: int
    wire: int
    send_tree: np.ndarray  # (n,) int32
    send_off: np.ndarray   # (n,) int32: element offset of v's window
    recv_tree: np.ndarray  # (n,) int32
    recv_off: np.ndarray   # (n,) int32
    recv_len: np.ndarray   # (n,) int32: true window length (0: no arrival)


@dataclass(frozen=True, eq=False)
class StripedTables:
    """Element-level tables of one (spec, payload size, fractions) bind.

    All trees stripe their PADDED row of width ``mrow`` through the same
    slot->offset table ``offsets`` (padding elements are zero everywhere,
    so reducing/gathering them is harmless and keeps every window a
    single circular interval even under weighted fractions)."""
    sizes: tuple           # per-tree true chunk widths (sum == payload size)
    mrow: int              # common padded row width == max(sizes)
    smax: int              # widest owner stripe, ceil(mrow / n)
    offsets: np.ndarray    # (n+1,) int32: slot i owns [offsets[i], offsets[i+1])
    own_off: np.ndarray    # (k, n) int32: offset of v's own stripe in tree j
    own_len: np.ndarray    # (k, n) int32: width of v's own stripe in tree j
    waves: tuple           # composed program, tuple[BoundStripedWave]
    rs_waves: tuple
    ag_waves: tuple


def _bind_waves(spec, waves, offsets, mrow):
    out = []
    n = spec.n
    for wv in waves:
        send_tree = np.zeros(n, np.int32)
        send_off = np.zeros(n, np.int32)
        recv_tree = np.zeros(n, np.int32)
        recv_off = np.zeros(n, np.int32)
        recv_len = np.zeros(n, np.int32)
        perm, wire = [], 0
        for (j, kind, s, d), (src, dst) in zip(wv.msgs, wv.perm):
            slot, nslot = int(wv.send_slot[s]), int(wv.send_nslot[s])
            off = int(offsets[slot])
            if slot + nslot <= n:
                length = int(offsets[slot + nslot]) - off
            else:                     # window wraps the circular slot space
                length = (mrow - off) + int(offsets[slot + nslot - n])
            if length == 0:
                continue              # every slot in the window is empty
            perm.append((src, dst))
            wire = max(wire, length)
            send_tree[src], send_off[src] = j, off
            recv_tree[dst], recv_off[dst], recv_len[dst] = j, off, length
        if perm:
            out.append(BoundStripedWave(tuple(perm), wv.op, wire, send_tree,
                                        send_off, recv_tree, recv_off,
                                        recv_len))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def striped_tables(spec: StripedCollectiveSpec, size: int,
                   fractions=None) -> StripedTables:
    """Bind ``spec``'s slot windows to a concrete flattened payload of
    ``size`` elements (optionally striped across trees by ``fractions``).
    Owner stripes partition each tree's padded row exactly
    (largest-remainder :func:`chunk_sizes` over the n vertices); stripes
    can be empty when ``mrow < n`` and their messages are dropped.
    Cached by (spec, size, fractions): trace-time rebinds are free."""
    k = max(1, spec.k)
    fr = tuple(fractions) if fractions is not None else (1.0 / k,) * k
    if spec.k and len(fr) != spec.k:
        raise ValueError(f"{len(fr)} fractions for k={spec.k} trees")
    sizes = chunk_sizes(size, fr)
    mrow = max(1, max(sizes) if sizes else 0)
    n = max(1, spec.n)
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(chunk_sizes(mrow, (1.0 / n,) * n))
    widths = np.diff(offsets)
    own_off = np.zeros((spec.k, spec.n), np.int32)
    own_len = np.zeros((spec.k, spec.n), np.int32)
    for j, st in enumerate(spec.trees):
        own_off[j] = offsets[:-1][st.pre]
        own_len[j] = widths[st.pre]
    return StripedTables(
        sizes=sizes, mrow=mrow, smax=int(widths.max()) if n else 0,
        offsets=offsets, own_off=own_off, own_len=own_len,
        waves=_bind_waves(spec, spec.waves, offsets, mrow),
        rs_waves=_bind_waves(spec, spec.rs_waves, offsets, mrow),
        ag_waves=_bind_waves(spec, spec.ag_waves, offsets, mrow))


@functools.lru_cache(maxsize=256)
def owner_element_map(spec: StripedCollectiveSpec, size: int,
                      fractions=None) -> np.ndarray:
    """Element-level ownership of one (spec, payload size, fractions)
    bind: ``map[v, j, i]`` is the flat payload index of the ``i``-th
    element of vertex ``v``'s owner stripe in tree ``j`` (the exact
    layout ``tree_reduce_scatter`` hands back), or ``-1`` where the
    ``(k, smax)`` stripe stack is padding.  Every payload element
    appears exactly once, so the map converts owner-stripe state (ZeRO-1
    optimizer moments, sharded checkpoints) between any two stripe
    geometries -- healthy vs degraded fractions, k vs k-1 trees, or
    different fabrics entirely.  Cached and returned read-only."""
    t = striped_tables(spec, size, fractions)
    out = np.full((spec.n, spec.k, t.smax), -1, np.int64)
    chunk_off = np.zeros(spec.k + 1, np.int64)
    chunk_off[1:] = np.cumsum(t.sizes)
    for j in range(spec.k):
        for v in range(spec.n):
            # single-slot windows never wrap the circular row
            off, ln = int(t.own_off[j, v]), int(t.own_len[j, v])
            width = min(ln, int(t.sizes[j]) - off)   # trim row padding
            if width > 0:
                out[v, j, :width] = chunk_off[j] + off \
                    + np.arange(width, dtype=np.int64)
    out.setflags(write=False)
    return out


@dataclass
class StripedSimResult:
    ok: bool
    rounds: int
    max_link_load: int
    per_link_bytes: dict
    wire_elems: tuple       # per composed wave: padded wire length
    max_wire: int           # max over waves
    stripes_ok: bool        # per-stripe conservation held


def _replay_striped(state, bound_waves, mrow):
    link_bytes: dict = {}
    wire_elems = []
    max_load = 0
    for w, bw in enumerate(bound_waves):
        srcs = [s for s, _ in bw.perm]
        dsts = [d for _, d in bw.perm]
        assert len(set(srcs)) == len(srcs), "wave reuses a source"
        assert len(set(dsts)) == len(dsts), "wave reuses a destination"
        wire_elems.append(bw.wire)
        staged = []
        loads: dict = {}
        for s, d in bw.perm:
            j = int(bw.send_tree[s])
            off, length = int(bw.send_off[s]), int(bw.recv_len[d])
            idxs = (off + np.arange(length)) % mrow
            staged.append((d, j, idxs, state[s, j, idxs].copy()))
            # like the pipelined replay, loads are DIRECTED: a wave may
            # drive one undirected link both ways at once (full duplex)
            loads[(s, d)] = loads.get((s, d), 0) + 1
            link_bytes[(s, d)] = link_bytes.get((s, d), 0) + length
        for d, j, idxs, payload in staged:
            if bw.op == REDUCE:
                state[d, j, idxs] += payload
            else:
                state[d, j, idxs] = payload
        if loads:
            max_load = max(max_load, max(loads.values()))
    return link_bytes, tuple(wire_elems), max_load


def _check_stripe_conservation(spec: StripedCollectiveSpec) -> bool:
    """Per-stripe conservation over the composed program: every owner
    slot of every tree crosses each of the tree's n-1 edges exactly once
    during reduce-scatter and exactly once during allgather (in the one
    direction its ownership dictates), and never twice on one edge in
    one phase."""
    n = spec.n
    for j, st in enumerate(spec.trees):
        tally: dict = {}
        for wv in spec.waves:
            for (tj, kind, s, d) in wv.msgs:
                if tj != j:
                    continue
                c = s if kind in (RS_UP, AG_UP) else d
                lo, ns = ((int(st.pre[c]), int(st.size[c]))
                          if kind in (RS_DOWN, AG_UP) else
                          ((int(st.pre[c]) + int(st.size[c])) % n,
                           n - int(st.size[c])))
                phase = "rs" if kind in _RS_KINDS else "ag"
                for slot in ((lo + t) % n for t in range(ns)):
                    key = (slot, canon(s, d), phase)
                    tally[key] = tally.get(key, 0) + 1
                    if tally[key] > 1:
                        return False
        edges = {canon(int(st.parent[v]), v)
                 for v in range(n) if st.parent[v] >= 0}
        for slot in range(n):
            for phase in ("rs", "ag"):
                if sum(tally.get((slot, e, phase), 0) for e in edges) \
                        != n - 1:
                    return False
    return True


def simulate_striped_program(spec: StripedCollectiveSpec, values: np.ndarray,
                             fractions=None) -> StripedSimResult:
    """Packet-level replay of the composed striped allreduce: checks
    that every vertex ends with the global sum, that no wave reuses a
    source/destination, that per-stripe conservation holds (each owner
    slot crosses each tree edge exactly once per phase), and records the
    per-wave wire lengths (all <= ceil(m/n) * slots-per-window < m)."""
    n, d = values.shape
    if spec.k == 0:
        return StripedSimResult(False, 0, 0, {}, (), 0, False)
    assert n == spec.n
    bound = striped_tables(spec, d,
                           None if fractions is None else tuple(fractions))
    mrow = bound.mrow
    state = np.zeros((n, spec.k, mrow))
    off = 0
    for j, s in enumerate(bound.sizes):
        state[:, j, :s] = values[:, off:off + s]
        off += s
    expected = state.sum(0)
    link_bytes, wire_elems, max_load = _replay_striped(state, bound.waves,
                                                       mrow)
    ok = bool(np.allclose(state, expected[None]))
    return StripedSimResult(
        ok=ok, rounds=len(bound.waves),
        max_link_load=max_load, per_link_bytes=link_bytes,
        wire_elems=wire_elems,
        max_wire=max(wire_elems) if wire_elems else 0,
        stripes_ok=_check_stripe_conservation(spec))


# ---------------------------------------------------------------------------
# NumPy packet-level simulator (correctness + link-load accounting)
# ---------------------------------------------------------------------------

@dataclass
class SimResult:
    ok: bool
    rounds: int
    max_link_load: int      # max messages crossing one link in one round
    per_link_bytes: dict    # link -> total bytes carried


def simulate_allreduce(sched: AllreduceSchedule, values: np.ndarray,
                       chunk_bytes: int = 1) -> SimResult:
    """values: (n, d) per-node vectors, d divisible by k.  Executes the
    schedule literally and checks every node ends with the global sum."""
    n, d = values.shape
    k = sched.k
    assert d % k == 0
    m = d // k
    chunks = values.reshape(n, k, m).astype(np.float64).copy()
    expected = values.sum(axis=0)
    link_bytes: dict = {}
    max_load = 0
    rounds = 0

    for phase in ("reduce", "bcast"):
        for msgs in sched.global_rounds(phase):
            rounds += 1
            loads: dict = {}
            staged = []
            for j, s, dst in msgs:
                payload = chunks[s, j].copy()
                staged.append((j, dst, payload))
                e = canon(s, dst)
                loads[e] = loads.get(e, 0) + 1
                link_bytes[e] = link_bytes.get(e, 0) + m * chunk_bytes
            for j, dst, payload in staged:
                if phase == "reduce":
                    chunks[dst, j] += payload
                else:
                    chunks[dst, j] = payload
            if loads:
                max_load = max(max_load, max(loads.values()))

    final = chunks.reshape(n, d)
    ok = bool(np.allclose(final, expected[None, :].repeat(n, 0)))
    return SimResult(ok, rounds, max_load, link_bytes)


# ---------------------------------------------------------------------------
# alpha-beta cost model (paper Sec. 1.1: collective bandwidth)
# ---------------------------------------------------------------------------

def wave_wire_bytes(spec, nbytes: float, itemsize: int = 4,
                    fractions=None) -> tuple:
    """Per-wave wire bytes of any compiled spec, in program order.

    The chunk engines (pipelined / fused / per-tree) ship one padded
    ``mrow``-element row per hop, so every wave carries the same wire;
    the striped engine's waves carry their bound stripe-window widths
    (:func:`striped_tables`).  This is the static per-wave twin of the
    makespan methods below -- the telemetry layer renders it as span
    widths and the timing harness diffs it against measurement."""
    k = spec.k
    if k == 0:
        return ()
    elems = max(1, -(-int(nbytes) // itemsize))
    if isinstance(spec, StripedCollectiveSpec):
        fr = None if fractions is None else tuple(fractions)
        bound = striped_tables(spec, elems, fr)
        return tuple(int(w.wire) * itemsize for w in bound.waves)
    fracs = tuple(fractions) if fractions is not None else (1.0 / k,) * k
    row_bytes = max(chunk_sizes(elems, fracs)) * itemsize
    if isinstance(spec, PipelinedAllreduceSpec):
        nwaves = len(spec.waves)
    elif isinstance(spec, FusedAllreduceSpec):
        nwaves = len(spec.reduce_rounds) + len(spec.bcast_rounds)
    else:
        # the per-tree form lives in repro_torch.dist.tree_allreduce
        # (a torch-importing module), so it is duck-typed on its rounds
        nwaves = sum(len(t.reduce_rounds) + len(t.bcast_rounds)
                     for t in spec.trees)
    return (row_bytes,) * nwaves


@dataclass
class CostModel:
    link_bw: float = 50e9      # bytes/s per link (ICI default)
    alpha: float = 1e-6        # per-message latency (s)
    segment: int = 256 * 1024  # pipeline segment bytes
    overlap: bool = True       # can a step's disjoint-link waves overlap?

    # Measured calibrations registered at runtime take precedence over
    # the built-in per-backend constants below.  Both built-in rows are
    # the reference's constants, kept as they are: "cpu" for its XLA
    # host backend, "tpu" (the class defaults) for TPU ICI.  No CUDA
    # calibration has been measured, so "cuda" has no row.
    _MEASURED = {}          # plain class attrs, not dataclass fields
    _BUILTIN = {
        # XLA host backend (fake devices): every collective serializes at
        # high per-call latency, so alpha dominates and pipelining never
        # pays -- the autotuner then picks S=1, which the executor
        # unrolls with zero pipeline overhead.
        "cpu": {"link_bw": 2e8, "alpha": 5.5e-4, "overlap": False},
        # the class defaults model a real fabric (per-link DMA engines:
        # waves on disjoint links overlap), calibrated against TPU ICI
        "tpu": {},
    }
    _WARNED_BACKENDS = set()

    @classmethod
    def register_calibration(cls, backend: str, **constants) -> None:
        """Register measured constants (``link_bw`` / ``alpha`` /
        ``segment`` / ``overlap``) for a backend; subsequent
        :meth:`for_backend` calls -- and therefore the segment autotuner
        -- use them."""
        known = {f.name for f in cls.__dataclass_fields__.values()} \
            if hasattr(cls, "__dataclass_fields__") else set()
        bad = set(constants) - known
        if bad:
            raise ValueError(f"unknown CostModel constants {sorted(bad)}")
        cls._MEASURED[backend] = dict(constants)

    @classmethod
    def calibration_for(cls, backend: str | None) -> dict | None:
        """The constants :meth:`for_backend` would use, or ``None`` when
        the backend has neither a measured nor a built-in calibration."""
        if backend in cls._MEASURED:
            return cls._MEASURED[backend]
        return cls._BUILTIN.get(backend)

    @classmethod
    def _warn_no_calibration(cls, backend) -> None:
        """Log the unknown-backend fallback at most ONCE per backend
        name.  ``for_backend`` sits inside the segment-autotune and
        codec-policy loops, which probe it once per (payload, S)
        candidate -- an unguarded warning there floods the log with one
        line per candidate."""
        if backend in cls._WARNED_BACKENDS:
            return
        cls._WARNED_BACKENDS.add(backend)
        logger.warning(
            "CostModel has no calibration for backend %r; falling "
            "back to the default fabric constants (segments='auto' "
            "and codec='auto' may mispick); register a measured "
            "one with CostModel.register_calibration.",
            backend)

    @classmethod
    def for_backend(cls, backend: str | None) -> "CostModel":
        """Constants calibrated for where the program actually runs:
        measured (``register_calibration``) first, then the built-in
        per-backend table.  A backend with NO calibration falls back to
        the default fabric constants *explicitly*: the fallback is
        logged (once per backend, via ``_warn_no_calibration``) because
        the segment autotuner and the codec policy both read these
        constants, and silently modelling an unknown backend as a
        TPU-like fabric is exactly how ``segments="auto"`` mispicks."""
        consts = cls.calibration_for(backend)
        if consts is None:
            cls._warn_no_calibration(backend)
            consts = {}
        return cls(**consts)

    def pipelined_allreduce(self, nbytes: float, spec,
                            segments: int) -> float:
        """Modelled cost of the wave program streaming S segments:
        ``(waves + S - 1)`` steps of ``(m/S)``-sized hops when a step's
        waves overlap (disjoint links -- the EDST property), or the full
        serialized collective count when they cannot (host backends,
        where the S>1 scan issues every wave each step)."""
        waves = max(1, spec.num_collectives)
        seg = nbytes / max(1, spec.k) / segments
        steps = spec.steps(segments) if hasattr(spec, "steps") \
            else waves + segments - 1
        if self.overlap:
            return steps * (self.alpha + seg / self.link_bw)
        ncoll = waves if segments == 1 else waves * steps
        return ncoll * (self.alpha + seg / self.link_bw)

    def striped_allreduce(self, nbytes: float, spec,
                          itemsize: int = 4) -> float:
        """Modelled cost of the composed striped program
        (:class:`StripedCollectiveSpec`): its waves run in dependency
        order, each shipping its bound wire length (stripe windows, not
        the full chunk), so the per-wave wire bytes fall from ``m``
        toward ``ceil(m/n) * slots-per-window`` at roughly twice the
        wave count of the pipelined engine.  Bandwidth-dominated fabrics
        win on the smaller wires; alpha-dominated hosts lose on the
        extra waves -- which is the engine-selection tradeoff
        ``repro.dist`` documents."""
        elems = max(1, int(nbytes // itemsize))
        bound = striped_tables(spec, elems)
        return sum(self.alpha + w.wire * itemsize / self.link_bw
                   for w in bound.waves)

    def wave_times(self, spec, nbytes: float, itemsize: int = 4,
                   fractions=None, segments: int = 1) -> tuple:
        """Predicted seconds per wave, in program order: ``alpha +
        wire/bw`` over :func:`wave_wire_bytes`.  The per-wave
        decomposition of the makespan methods above -- what the
        telemetry trace renders as predicted span durations and the
        wave-by-wave timing harness (``repro.telemetry.timing``) diffs
        against measurement.  ``segments`` > 1 (chunk engines only)
        repeats the wave sequence once per segment at ``1/S`` of the row
        bytes, the serialized-host reading of the streamed program."""
        wires = wave_wire_bytes(spec, nbytes, itemsize, fractions)
        if segments > 1 and not isinstance(spec, StripedCollectiveSpec):
            wires = tuple(-(-w // segments) for w in wires) * segments
        return tuple(self.alpha + w / self.link_bw for w in wires)

    def best_segments(self, nbytes: float, spec, smax: int = 64) -> int:
        """The segment count minimizing :meth:`pipelined_allreduce`
        (powers of two up to ``smax``)."""
        best, best_s = float("inf"), 1
        s = 1
        while s <= smax:
            t = self.pipelined_allreduce(nbytes, spec, s)
            if t < best:
                best, best_s = t, s
            s *= 2
        return best_s

    def ring_allreduce(self, nbytes: float, p: int) -> float:
        """bidirectional-ring reduce-scatter + all-gather."""
        steps = 2 * (p - 1)
        return steps * self.alpha + 2 * nbytes * (p - 1) / p / self.link_bw

    def edst_tree_allreduce(self, nbytes: float, sched: AllreduceSchedule,
                            in_network: bool = False) -> float:
        """k trees, chunk nbytes/k each, segment-pipelined along tree depth.

        endpoint mode (TPU): reduce up + broadcast down -> 2 traversals.
        in-network mode (paper's switches): single traversal each way but the
        switch reduces, so the endpoint link carries each chunk once -> the
        2x disappears into the fabric.
        """
        k = sched.k
        chunk = nbytes / k
        t = 0.0
        for ts in sched.trees:
            depth = max(ts.depth, 1)
            nseg = max(1, int(np.ceil(chunk / self.segment)))
            seg = chunk / nseg
            fill = depth * (self.alpha + seg / self.link_bw)
            stream = (nseg - 1) * seg / self.link_bw
            traversals = 1.0 if in_network else 2.0
            t = max(t, traversals * (fill + stream))
        return t

    def single_tree_allreduce(self, nbytes: float, sched_one: TreeSchedule,
                              in_network: bool = False) -> float:
        one = AllreduceSchedule(sched_one.n, [sched_one])
        return self.edst_tree_allreduce(nbytes, one, in_network)

    def speedup_vs_ring(self, nbytes: float, p: int,
                        sched: AllreduceSchedule) -> float:
        return self.ring_allreduce(nbytes, p) / self.edst_tree_allreduce(nbytes, sched)
