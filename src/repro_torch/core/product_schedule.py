"""Compositional star-product schedule compiler (compile-time perf layer):
the port's copy of the reference's ``repro.core.product_schedule``.

The flat path to a compiled wave program materializes the product graph,
re-proves the EDST set edge-by-edge (``StarEDSTs.verify``), BFS-tree-ifies
every construction subgraph against it, and greedily list-schedules a
message DAG with an O(waves * messages) ready-scan -- minutes of Python on
10k-node SlimFly/BundleFly/PolarStar fabrics.  This module assembles the
same artifacts compositionally, straight from *cached factor-graph*
structure:

  * :func:`composed_star_trees` -- the paper's Construction A/B (and
    extra-tree) edge sets assembled from cached factor EDSTs through the
    star bijections (``star_edsts(..., verify=False)``): supernode copies
    from the Gn trees, bundle/cross edges packed by ``sp.bundle`` /
    ``sp.cross_edge``, never touching ``sp.product()``.  A/B outputs are
    exact spanning trees by edge count ((ns-1)*nn bundle edges + (nn-1)
    supernode edges = N-1), so tree-ification and the per-tree
    spanning/disjointness scan are skipped -- the *compiled program* is
    vetted by the static verifier instead
    (``repro_torch.analysis.verify``).
  * :func:`composed_allreduce_schedule` -- an ordinary
    :class:`~repro_torch.core.collectives.AllreduceSchedule` over those trees
    (depth-minimizing CSR tree-center roots), memoized on
    ``StarProduct.cache_key()`` so elastic rescales and fault-runtime
    rebuilds that land on an already-seen fabric reuse the composed
    schedule instead of recompiling.
  * :func:`asap_pipelined_spec` / :func:`asap_striped_spec` /
    :func:`asap_fused_spec` -- wave programs built by ASAP levelization:
    every message's earliest start is computed per tree in O(N) (reduce
    send = subtree height; broadcast send = reduce completion + depth;
    the four striped kinds via two leafward and two rootward sweeps),
    then messages are packed in ASAP order by earliest-wave placement:
    each message's earliest legal wave is one past the maximum wave of
    its dependencies (an O(1) per-vertex aggregate), and a short forward
    probe finds the first ppermute-legal (and, for striped,
    op-homogeneous) wave.  Every dependency lands in a strictly earlier
    wave, so the emitted order preserves happens-before -- the property
    the full-level verifier re-checks.  Total cost is near-linear in
    messages, replacing the O(waves x messages) greedy ready-scan.
"""
from __future__ import annotations

from bisect import bisect_left
from itertools import chain

import numpy as np

from .collectives import (BCAST, REDUCE, RS_UP, RS_DOWN, AG_UP, AG_DOWN,
                          _RS_KINDS, AllreduceSchedule, FusedAllreduceSpec,
                          PipelinedAllreduceSpec, StripedCollectiveSpec,
                          StripedWave, _pipe_wave, _sched_key, _striped_op,
                          _striped_tree, _striped_wave, allreduce_schedule,
                          fused_spec_from_schedule, verify_compiled_spec)
from .edst_star import StarEDSTs, star_edsts
from .factor_edsts import EDSTSet, edsts_for
from .star import StarProduct

# ---------------------------------------------------------------------------
# cached factor EDSTs + composed schedules
# ---------------------------------------------------------------------------

_FACTOR_CACHE: dict = {}      # (n, frozenset(edges)) -> EDSTSet
_SCHED_CACHE: dict = {}       # (sp key, E keys, strategy, roots) -> schedule
_PIPE_CACHE: dict = {}        # composed-spec caches, keyed like the flat
_STRIPED_CACHE: dict = {}     # compilers' but tagged "composed"


def factor_edsts_cached(g) -> EDSTSet:
    """``edsts_for`` memoized by graph value: the same factor (an ER_q
    polarity graph, a Paley supernode, a cycle of a torus) is packed once
    per process no matter how many product fabrics reuse it."""
    key = (g.n, frozenset(g.edges))
    hit = _FACTOR_CACHE.get(key)
    if hit is None:
        hit = _FACTOR_CACHE[key] = edsts_for(g)
    return hit


def _edst_key(es: EDSTSet | None):
    return None if es is None else tuple(frozenset(t) for t in es.trees)


def composed_star_trees(sp: StarProduct, Es: EDSTSet | None = None,
                        En: EDSTSet | None = None,
                        strategy: str = "auto") -> StarEDSTs:
    """Product EDSTs assembled from (cached) factor EDSTs without
    materializing or re-verifying against the product graph."""
    Es = Es or factor_edsts_cached(sp.gs)
    En = En or factor_edsts_cached(sp.gn)
    return star_edsts(sp, Es, En, strategy=strategy, verify=False)


def composed_allreduce_schedule(sp: StarProduct, Es: EDSTSet | None = None,
                                En: EDSTSet | None = None,
                                strategy: str = "auto",
                                roots=None) -> AllreduceSchedule:
    """The composed :class:`AllreduceSchedule` of a star-product fabric,
    memoized on ``sp.cache_key()``: recompiles (elastic rescale probes,
    fault-runtime rebuilds, repeated spec lookups) return the identical
    object, which keys the spec caches below."""
    key = (sp.cache_key(), _edst_key(Es), _edst_key(En), strategy, roots)
    hit = _SCHED_CACHE.get(key)
    if hit is not None:
        return hit
    res = composed_star_trees(sp, Es, En, strategy)
    sched = allreduce_schedule(sp.n, res.trees, roots=roots)
    _SCHED_CACHE[key] = sched
    return sched


# ---------------------------------------------------------------------------
# ASAP levelization (O(messages) wave assembly)
# ---------------------------------------------------------------------------

class _WaveAlloc:
    """Incremental wave allocator for earliest-wave placement.

    ``place(i, s, d, ew, op)`` puts message ``i`` in the first wave at
    index >= ``ew`` whose source set misses ``s``, destination set misses
    ``d``, and (for the striped engine) whose op matches; a new wave is
    opened past the end otherwise.  Since ``ew`` is always one past the
    maximum wave of every dependency, the emitted wave order preserves
    happens-before while packing independent messages together the way
    the greedy list scheduler does."""

    def __init__(self):
        self.srcs, self.dsts, self.ops, self.waves = [], [], [], []

    def place(self, i, s, d, ew, op=0):
        w = ew
        while w < len(self.waves) and (self.ops[w] != op
                                       or s in self.srcs[w]
                                       or d in self.dsts[w]):
            w += 1
        if w == len(self.waves):
            self.srcs.append(set())
            self.dsts.append(set())
            self.ops.append(op)
            self.waves.append([])
        self.srcs[w].add(s)
        self.dsts[w].add(d)
        self.waves[w].append(i)
        return w


def _pipe_asap(sched: AllreduceSchedule):
    """Every (tree, kind, src, dst) pipelined message with its critical-
    path priority (negated height: longest dependent chain, the same
    priority the flat list scheduler sorts by), computed per tree in O(N).

    Per tree: a broadcast (p -> c) heads a chain of length hb(c), the
    bcast-subtree height of c; a reduce into v heads R(v) with
    R(root) = 1 + max child hb and R(v) = 1 + R(parent) below.  A
    dependency's height strictly exceeds its dependent's, so ascending
    priority order processes dependencies first -- the invariant
    earliest-wave placement needs.  ``q8_pri`` are the standalone-phase
    heights (cross-kind chains dropped) for the phase-separated quantized
    program.
    """
    msgs, pri, q8_pri = [], [], []
    for j, ts in enumerate(sched.trees):
        hb: dict = {}
        for lvl in reversed(ts.bcast_rounds):     # children before parents
            for p, c in lvl:
                hb.setdefault(c, 0)
                if hb[c] + 1 > hb.get(p, 0):
                    hb[p] = hb[c] + 1
        red: dict = {ts.root: 1 + hb.get(ts.root, 0)}
        dep: dict = {ts.root: 0}
        for lvl in ts.bcast_rounds:               # parents before children
            for p, c in lvl:
                red[c] = 1 + red[p]
                dep[c] = 1 + dep[p]
                msgs.append((j, REDUCE, c, p))
                pri.append(-red[p])
                q8_pri.append(-dep[c])            # red-only chain = depth
                msgs.append((j, BCAST, p, c))
                pri.append(-hb[c])
                q8_pri.append(-hb[c])
    return msgs, pri, q8_pri


def _pipe_place(sched: AllreduceSchedule, msgs, pri, ids, mixed: bool,
                tiebreak=None):
    """Earliest-wave placement of pipelined messages, processed in
    critical-path priority order (dependencies strictly first, longest
    chains grab slots first -- the flat scheduler's priority).
    Dependency waves aggregate into per-vertex maxima --
    ``maxw_red[(j, v)]`` is the last wave of a reduce into ``v`` and
    ``wave_bc[(j, v)]`` the wave of the broadcast into ``v`` -- making
    each earliest-wave bound O(1).  With ``mixed`` false the broadcast
    kind restarts from wave 0 (the standalone q8 phase drops cross-kind
    dependencies, mirroring the ``kinds`` filter of the flat list
    scheduler)."""
    alloc = _WaveAlloc()
    maxw_red: dict = {}
    wave_bc: dict = {}
    roots = [ts.root for ts in sched.trees]
    if tiebreak is None:
        order = sorted(ids, key=lambda i: (pri[i], msgs[i][1], msgs[i][0],
                                           msgs[i][2]))
    else:
        order = sorted(ids, key=lambda i: (pri[i], tiebreak[i]))
    for i in order:
        j, kind, s, d = msgs[i]
        if kind == REDUCE:
            w = alloc.place(i, s, d, maxw_red.get((j, s), -1) + 1)
            if w > maxw_red.get((j, d), -1):
                maxw_red[(j, d)] = w
        else:
            if s == roots[j]:
                base = maxw_red.get((j, s), -1) if mixed else -1
            else:
                base = wave_bc[(j, s)]
            wave_bc[(j, d)] = alloc.place(i, s, d, base + 1)
    return alloc.waves


def asap_pipelined_spec(sched: AllreduceSchedule, axis_names,
                        verify=None) -> PipelinedAllreduceSpec:
    """Compile an :class:`AllreduceSchedule` into a
    :class:`PipelinedAllreduceSpec` by ASAP levelization + earliest-wave
    placement (O(messages)) instead of the greedy list schedule.  Cached
    like the flat compiler but under a ``"composed"``-tagged key, so flat
    and composed programs of one fabric coexist (and the benchmark can
    compare them)."""
    axes = tuple(axis_names)
    key = (*_sched_key(sched, axes), "pipelined", "composed")
    hit = _PIPE_CACHE.get(key)
    if hit is not None:
        if verify:
            verify_compiled_spec(hit, verify, "asap_pipelined_spec")
        return hit
    msgs, pri, q8_pri = _pipe_asap(sched)
    n, k = sched.n, sched.k
    ids = range(len(msgs))
    waves = tuple(_pipe_wave(n, k, msgs, take)
                  for take in _pipe_place(sched, msgs, pri, ids, True))
    red = [_pipe_wave(n, k, msgs, take) for take in _pipe_place(
        sched, msgs, q8_pri,
        [i for i in ids if msgs[i][1] == REDUCE], False)]
    bc = [_pipe_wave(n, k, msgs, take) for take in _pipe_place(
        sched, msgs, q8_pri,
        [i for i in ids if msgs[i][1] == BCAST], False)]
    spec = PipelinedAllreduceSpec(n=n, k=k, axes=axes, depth=sched.depth,
                                  waves=waves, q8_waves=tuple(red + bc),
                                  q8_boundary=len(red), key=key)
    verify_compiled_spec(spec, verify, "asap_pipelined_spec")
    _PIPE_CACHE[key] = spec
    return spec


def _striped_asap(sched: AllreduceSchedule, trees):
    """Every striped message with its critical-path priority (negated
    height over the superset dependency DAG -- sibling "other children"
    terms widened to all children, see ``_striped_dag`` for the true
    rules), computed per tree in four O(N) sweeps.

    With hu/hd/au/ad the heights of the RS_UP/RS_DOWN/AG_UP/AG_DOWN
    message attached to a (vertex -> parent) tree edge, transposing the
    superset rules gives (maxima over children c, parent p):

      ad(v) = 1 + max_c ad(c)                       (leafward sweep)
      au(v) = 1 + max(au(p), max_{c of p} ad(c))    (rootward sweep)
      hd(v) = 1 + max(max_c hd(c), au(v), max_c ad(c))   (leafward)
      hu(v) = 1 + max(hu(p), au(p), max_{c of p} hd(c), max_{c of p} ad(c))

    A superset dependency's height strictly exceeds its dependent's (and
    the true dependencies are a subset), so ascending priority order
    processes dependencies first.  ``solo_pri`` holds the phase-local
    heights (cross-phase terms dropped) for the standalone ``rs_waves`` /
    ``ag_waves`` programs.

    Alongside ``(msgs, pri, solo_pri, ops)`` the sweep returns the
    per-message slot-window arrays ``(j, s, d, slot, nslot)`` as int32
    numpy columns, precomputed here (2 tree-table reads per vertex
    instead of 6 per wave-build) so wave assembly can scatter them in
    bulk."""
    n = sched.n
    msgs, pri, solo_pri, ops = [], [], [], []
    c_j, c_s, c_d, c_slot, c_nslot = [], [], [], [], []
    for j, (ts, st) in enumerate(zip(sched.trees, trees)):
        parent = st.parent.tolist()
        pre = st.pre.tolist()
        size = st.size.tolist()
        down = [c for lvl in ts.bcast_rounds for _, c in lvl]
        rdown = down[::-1]
        ad = [0] * n
        mad = [0] * n         # max ad over children
        au = [0] * n
        hd = [0] * n
        mhd = [0] * n         # max hd over children
        hu = [0] * n
        ad2 = [0] * n
        mad2 = [0] * n
        au2 = [0] * n
        hd2 = [0] * n
        mhd2 = [0] * n
        hu2 = [0] * n
        for v in rdown:                            # children before parents
            a = ad[v] = 1 + mad[v]
            a2 = ad2[v] = 1 + mad2[v]
            p = parent[v]
            if a > mad[p]:
                mad[p] = a
            if a2 > mad2[p]:
                mad2[p] = a2
        for v in down:                             # parents before children
            p = parent[v]
            au[v] = 1 + (au[p] if au[p] > mad[p] else mad[p])
            au2[v] = 1 + (au2[p] if au2[p] > mad2[p] else mad2[p])
        for v in rdown:
            h = hd[v] = 1 + max(mhd[v], au[v], mad[v])
            h2 = hd2[v] = 1 + mhd2[v]
            p = parent[v]
            if h > mhd[p]:
                mhd[p] = h
            if h2 > mhd2[p]:
                mhd2[p] = h2
        for v in down:
            p = parent[v]
            hu[v] = 1 + max(hu[p], au[p], mhd[p], mad[p])
            hu2[v] = 1 + (hu2[p] if hu2[p] > mhd2[p] else mhd2[p])
        for v in down:
            p = parent[v]
            below_slot, below_n = pre[v], size[v]
            above_slot = (below_slot + below_n) % n
            above_n = n - below_n
            msgs.append((j, RS_UP, v, p))
            pri.append(-hu[v])
            solo_pri.append(-hu2[v])
            ops.append(REDUCE)
            c_j.append(j); c_s.append(v); c_d.append(p)
            c_slot.append(above_slot); c_nslot.append(above_n)
            msgs.append((j, RS_DOWN, p, v))
            pri.append(-hd[v])
            solo_pri.append(-hd2[v])
            ops.append(REDUCE)
            c_j.append(j); c_s.append(p); c_d.append(v)
            c_slot.append(below_slot); c_nslot.append(below_n)
            msgs.append((j, AG_UP, v, p))
            pri.append(-au[v])
            solo_pri.append(-au2[v])
            ops.append(BCAST)
            c_j.append(j); c_s.append(v); c_d.append(p)
            c_slot.append(below_slot); c_nslot.append(below_n)
            msgs.append((j, AG_DOWN, p, v))
            pri.append(-ad[v])
            solo_pri.append(-ad2[v])
            ops.append(BCAST)
            c_j.append(j); c_s.append(p); c_d.append(v)
            c_slot.append(above_slot); c_nslot.append(above_n)
    cols = tuple(np.asarray(c, np.int32)
                 for c in (c_j, c_s, c_d, c_slot, c_nslot))
    return msgs, pri, solo_pri, ops, cols


def _striped_place(order, kind_a, bs_a, bd_a, s_a, d_a, op_a, phase: str,
                   kn: int):
    """Earliest-wave placement of the four striped kinds (``phase`` is
    ``"mixed"``, ``"rs"`` or ``"ag"``), processed in critical-path
    priority order (``order``; the caller lexsorts, dependencies strictly
    first).  Per-vertex aggregates mirror the ``_striped_dag`` dependency
    rules with the same whole-children superset relaxation as the height
    sweeps: ``up``/``agup`` hold the last wave of an RS_UP/AG_UP into a
    vertex, ``rsdn``/``agdn`` the wave of its down-pass message (indexed
    ``tree * n + vertex``, the ``bs_a``/``bd_a`` columns).  The
    standalone phases drop cross-phase terms, matching the flat
    scheduler's ``kinds`` filter.  The wave allocator is inlined, fields
    stream in through one C-level ``zip``, and the forward probe walks
    only waves of the message's op (two bisected per-op index lists):
    this loop runs once per message per phase and dominates composed
    compile time."""
    up = [-1] * kn
    rsdn = [-1] * kn
    agup = [-1] * kn
    agdn = [-1] * kn
    srcs, dsts, waves = [], [], []
    red_w, bc_w = [], []        # wave ids per op, increasing
    ag_solo = phase == "ag"
    it = zip(order.tolist(), kind_a[order].tolist(), bs_a[order].tolist(),
             bd_a[order].tolist(), s_a[order].tolist(),
             d_a[order].tolist(), op_a[order].tolist())
    for i, kind, bs, bd, s, d, op in it:
        if kind == RS_UP:
            ew = up[bs] + 1
        elif kind == RS_DOWN:
            ew = 1 + (up[bs] if up[bs] > rsdn[bs] else rsdn[bs])
        elif kind == AG_UP:
            ew = 1 + agup[bs] if ag_solo else \
                1 + max(rsdn[bs], up[bs], agup[bs])
        else:
            if ag_solo:
                ew = 1 + (agup[bs] if agup[bs] > agdn[bs] else agdn[bs])
            else:
                ew = 1 + max(up[bs], agup[bs], rsdn[bs], agdn[bs])
        lst = red_w if op == REDUCE else bc_w
        pos = bisect_left(lst, ew)
        end = len(lst)
        w = -1
        while pos < end:
            wi = lst[pos]
            if s not in srcs[wi] and d not in dsts[wi]:
                w = wi
                break
            pos += 1
        if w < 0:
            w = len(waves)
            lst.append(w)
            srcs.append({s})
            dsts.append({d})
            waves.append([i])
        else:
            srcs[w].add(s)
            dsts[w].add(d)
            waves[w].append(i)
        if kind == RS_UP:
            if w > up[bd]:
                up[bd] = w
        elif kind == RS_DOWN:
            rsdn[bd] = w
        elif kind == AG_UP:
            if w > agup[bd]:
                agup[bd] = w
        else:
            agdn[bd] = w
    return waves


def _striped_batch(n, msgs, ops, cols, takes):
    """Build the :class:`StripedWave` tuple for one phase in bulk: the
    six per-wave (n,) slot tables become rows of (W, n) arrays filled by
    a single vectorized scatter from the precomputed per-message columns
    (equivalent to ``_striped_wave`` per wave, minus the per-message
    Python slot arithmetic)."""
    c_j, c_s, c_d, c_slot, c_nslot = cols
    nw = len(takes)
    counts = np.fromiter(map(len, takes), np.int64, nw)
    flat = np.fromiter(chain.from_iterable(takes), np.int64,
                       int(counts.sum()))
    w_arr = np.repeat(np.arange(nw), counts)
    send_tree = np.zeros((nw, n), np.int32)
    send_slot = np.zeros((nw, n), np.int32)
    send_nslot = np.zeros((nw, n), np.int32)
    recv_tree = np.zeros((nw, n), np.int32)
    recv_slot = np.zeros((nw, n), np.int32)
    recv_nslot = np.zeros((nw, n), np.int32)
    s_f, d_f, j_f = c_s[flat], c_d[flat], c_j[flat]
    sl_f, ns_f = c_slot[flat], c_nslot[flat]
    send_tree[w_arr, s_f] = j_f
    send_slot[w_arr, s_f] = sl_f
    send_nslot[w_arr, s_f] = ns_f
    recv_tree[w_arr, d_f] = j_f
    recv_slot[w_arr, d_f] = sl_f
    recv_nslot[w_arr, d_f] = ns_f
    perm_all = list(zip(c_s.tolist(), c_d.tolist()))
    msg_get = msgs.__getitem__
    perm_get = perm_all.__getitem__
    out = []
    for w, take in enumerate(takes):
        out.append(StripedWave(tuple(map(perm_get, take)), ops[take[0]],
                               tuple(map(msg_get, take)),
                               send_tree[w], send_slot[w], send_nslot[w],
                               recv_tree[w], recv_slot[w], recv_nslot[w]))
    return tuple(out)


def asap_striped_spec(sched: AllreduceSchedule, axis_names,
                      verify=None) -> StripedCollectiveSpec:
    """Compile an :class:`AllreduceSchedule` into a
    :class:`StripedCollectiveSpec` by ASAP levelization + earliest-wave
    placement of the four-kind striped DAG (O(messages)), with
    op-homogeneous waves."""
    axes = tuple(axis_names)
    key = (*_sched_key(sched, axes), "striped", "composed")
    hit = _STRIPED_CACHE.get(key)
    if hit is not None:
        if verify:
            verify_compiled_spec(hit, verify, "asap_striped_spec")
        return hit
    trees = tuple(_striped_tree(sched.n, ts) for ts in sched.trees)
    msgs, pri, solo_pri, ops, cols = _striped_asap(sched, trees)
    n, k = sched.n, sched.k
    c_j, c_s, c_d = cols[0], cols[1], cols[2]
    kind_a = np.fromiter((m[1] for m in msgs), np.int64, len(msgs))
    op_a = np.asarray(ops, np.int64)
    pri_a = np.asarray(pri, np.int64)
    solo_a = np.asarray(solo_pri, np.int64)
    bs_a = c_j.astype(np.int64) * n + c_s
    bd_a = c_j.astype(np.int64) * n + c_d

    def waves_of(sub, pr, phase):
        order = sub[np.lexsort((c_s[sub], kind_a[sub], c_j[sub],
                                op_a[sub], pr[sub]))]
        takes = _striped_place(order, kind_a, bs_a, bd_a,
                               c_s, c_d, op_a, phase, k * n)
        return _striped_batch(n, msgs, ops, cols, takes)

    everything = np.arange(len(msgs))
    spec = StripedCollectiveSpec(
        n=n, k=k, axes=axes, depth=sched.depth, trees=trees,
        waves=waves_of(everything, pri_a, "mixed"),
        rs_waves=waves_of(np.nonzero(kind_a < AG_UP)[0], solo_a, "rs"),
        ag_waves=waves_of(np.nonzero(kind_a >= AG_UP)[0], solo_a, "ag"),
        key=key)
    verify_compiled_spec(spec, verify, "asap_striped_spec")
    _STRIPED_CACHE[key] = spec
    return spec


def asap_fused_spec(sched: AllreduceSchedule, axis_names,
                    verify=None) -> FusedAllreduceSpec:
    """The fused engine is already round-levelized (global rounds are BFS
    levels; no list schedule), so the composed path reuses the flat
    compiler -- its savings come from the composed trees upstream."""
    return fused_spec_from_schedule(sched, axis_names, verify)


# ---------------------------------------------------------------------------
# star-product entry point
# ---------------------------------------------------------------------------

def composed_spec_for_star(sp: StarProduct, axis_names,
                           engine: str = "pipelined",
                           Es: EDSTSet | None = None,
                           En: EDSTSet | None = None,
                           strategy: str = "auto", roots=None, verify=None):
    """Composed trees + ASAP wave assembly in one call: the full
    compositional compile of a star-product fabric.  Every layer is
    memoized (factor EDSTs, composed schedule, spec), so a 10k-node
    PolarStar compiles in seconds and recompiles for free."""
    sched = composed_allreduce_schedule(sp, Es, En, strategy, roots)
    if engine == "fused":
        return asap_fused_spec(sched, axis_names, verify)
    if engine == "striped":
        return asap_striped_spec(sched, axis_names, verify)
    if engine != "pipelined":
        raise ValueError(f"engine {engine!r} not in "
                         "('pipelined', 'fused', 'striped')")
    return asap_pipelined_spec(sched, axis_names, verify)
