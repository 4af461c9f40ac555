"""Multi-tree allreduce schedules from EDST sets (paper Sec. 1.1 payoff):
the subset of the reference's ``repro.core.collectives`` that the port's
pipelined engine runs.

A set of k EDSTs yields k contention-free reduction/broadcast trees: the
gradient is split into k chunks, chunk j is reduced leaves->root along tree j
and broadcast root->leaves, all trees concurrently.  Edge-disjointness
guarantees no two trees ever use the same physical link (asserted).

Kept here: the chunk apportioning helper, the per-tree schedules, the
list-scheduled pipelined wave program (:class:`PipelinedAllreduceSpec`) and
its packet-level simulator.  The compiled programs are not handed to a
static verifier in this package; instead the port's tests hold its tables
equal, array for array, to the reference's verified spec.  The list
scheduler's own self-check (:func:`_check_list_schedule`) stays, enabled by
``verify="full"``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .csr import tree_center
from .graph import canon, tree_depth_levels
# ---------------------------------------------------------------------------
# chunk apportioning (the canonical largest-remainder striping helper)
# ---------------------------------------------------------------------------

def chunk_sizes(total: int, fractions) -> tuple:
    """Apportion ``total`` elements by largest-remainder rounding; sizes sum
    exactly to ``total`` (a retired tree -- fraction 0 -- gets 0).

    The single canonical striping helper: per-tree chunk widths
    (``repro.dist.tree_allreduce``), weighted fault re-striping
    (``repro.dist.fault``), and per-vertex owner stripes
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
    double-BFS in :mod:`repro.core.csr` (three sweeps instead of the old
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


def allreduce_schedule(n: int, trees, roots=None) -> AllreduceSchedule:
    """Build the k-tree schedule.  ``roots`` may be explicit root ids or
    ``None`` (depth-minimizing tree centers via :func:`_best_root`)."""
    roots = roots or [None] * len(trees)
    sched = AllreduceSchedule(n, [tree_schedule(n, t, r)
                                  for t, r in zip(trees, roots)])
    assert sched.check_contention_free(), "trees share a link"
    return sched


def _resolve_verify(verify) -> str:
    """``verify`` level: ``None`` reads ``REPRO_VERIFY_SPECS`` (default
    ``"cheap"``), ``True``/``False`` mean ``"full"``/``"off"``.  Only
    ``"full"`` changes anything here: it turns on the list scheduler's
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


def _sched_key(sched: AllreduceSchedule, axes: tuple) -> tuple:
    return (sched.n, axes, tuple((ts.root, ts.tree) for ts in sched.trees))


# ---------------------------------------------------------------------------
# pipelined wave program (the segment-streaming compiled form)
# ---------------------------------------------------------------------------
#
# A round-major program (the reference's fused form) is still
# *round-aligned*: global round r waits for every tree's round r-1, fan-in overflow waves stall
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
                                 verify=None) -> PipelinedAllreduceSpec:
    """Compile an :class:`AllreduceSchedule` into the list-scheduled
    :class:`PipelinedAllreduceSpec` (greedy wave assembly).  Cached by
    (fabric, rooted trees, axes): recompiles return the identical object.
    ``verify="full"`` self-checks the list scheduler's waves."""
    axes = tuple(axis_names)
    key = (*_sched_key(sched, axes), "pipelined")
    hit = _PIPE_CACHE.get(key)
    if hit is not None:
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
    _PIPE_CACHE[key] = spec
    return spec


def empty_pipelined_spec(n: int, axis_names) -> PipelinedAllreduceSpec:
    """The k=0 program (no trees survive): executor passes data through."""
    axes = tuple(axis_names)
    return PipelinedAllreduceSpec(n=n, k=0, axes=axes, depth=0, waves=(),
                                  q8_waves=(), q8_boundary=0,
                                  key=(n, axes, (), "pipelined"))


@dataclass
class SimResult:
    ok: bool
    rounds: int
    max_link_load: int      # max messages crossing one link in one round
    per_link_bytes: dict    # link -> total bytes carried


def simulate_wave_program(spec, values: np.ndarray,
                          segments: int = 1, quantized: bool = False
                          ) -> SimResult:
    """Packet-level replay of the compiled wave program with the payload
    split into ``segments`` pipeline segments: at step t wave w moves
    segment ``t - w``, exactly as the scan executor does.  Checks that
    every vertex ends with the global sum and that no wave reuses a
    source or destination.  ``quantized`` replays ``q8_waves``."""
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
