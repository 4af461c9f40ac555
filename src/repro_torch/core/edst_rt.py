"""Roskind-Tarjan style maximum edge-disjoint spanning-forest packing.

The paper (Sec. 1.2) cites Roskind & Tarjan's O(n^2 k^2) algorithm as the
general-purpose way to find k EDSTs in an arbitrary graph.  We implement the
classic matroid-union augmentation: maintain k edge-disjoint forests; for each
graph edge run a BFS over (edge, forest) exchange moves; an augmenting
sequence ends at a forest where the edge closes no cycle.  The final packing
maximizes total forest size, hence contains t spanning trees whenever t
edge-disjoint spanning trees exist (Nash-Williams / Tutte).

Used for: factor graphs without explicit constructions (K_{q,q}, ER_q, C(q),
IQ(d), BDF(d)), and fault-tolerant rebuild after link failures (core/fault.py).
"""
from __future__ import annotations

from collections import deque

from .graph import Graph, canon, edges_are_spanning_tree


class _Forest:
    """One forest of the packing with O(n) path queries (BFS, graphs are small)."""

    def __init__(self, n: int):
        self.n = n
        self.adj = [set() for _ in range(n)]
        self.edges = set()

    def add(self, u: int, v: int):
        self.adj[u].add(v)
        self.adj[v].add(u)
        self.edges.add(canon(u, v))

    def remove(self, u: int, v: int):
        self.adj[u].discard(v)
        self.adj[v].discard(u)
        self.edges.discard(canon(u, v))

    def path(self, s: int, t: int):
        """Vertex path s..t inside the forest, or None if disconnected."""
        if s == t:
            return [s]
        prev = {s: s}
        dq = deque([s])
        while dq:
            u = dq.popleft()
            for w in self.adj[u]:
                if w not in prev:
                    prev[w] = u
                    if w == t:
                        out = [t]
                        while out[-1] != s:
                            out.append(prev[out[-1]])
                        return out[::-1]
                    dq.append(w)
        return None

    def connected(self, s: int, t: int) -> bool:
        return self.path(s, t) is not None


def pack_forests(g: Graph, k: int) -> list[set]:
    """Maximum packing of ``g``'s edges into k edge-disjoint forests."""
    forests = [_Forest(g.n) for _ in range(k)]
    where = {}  # edge -> forest index currently holding it

    for e0 in sorted(g.edges):
        _augment(forests, where, e0, k)
    return [set(f.edges) for f in forests]


def _augment(forests, where, e0, k) -> bool:
    """Try to add e0 to the packing via matroid-union augmentation (BFS)."""
    label = {e0: None}   # edge -> (pred_edge, forest_that_cycled)
    queue = deque([e0])
    tried = set()        # (edge, forest) pairs examined

    while queue:
        e = queue.popleft()
        u, v = e
        for fi in range(k):
            if (e, fi) in tried:
                continue
            tried.add((e, fi))
            f = forests[fi]
            if where.get(e) == fi:
                continue
            pth = f.path(u, v)
            if pth is None:
                _apply(forests, where, label, e, fi)
                return True
            # label cycle edges
            cyc = list(zip(pth, pth[1:]))
            for a, b in cyc:
                ce = canon(a, b)
                if ce not in label:
                    label[ce] = (e, fi)
                    queue.append(ce)
    return False


def _apply(forests, where, label, e, fi):
    """Walk the augmenting chain: insert e into forest fi, cascade swaps."""
    cur, into = e, fi
    while True:
        pred = label[cur]
        prev_forest = where.get(cur)
        forests[into].add(*cur)
        where[cur] = into
        if prev_forest is not None and prev_forest != into:
            forests[prev_forest].remove(*cur)
        if pred is None:
            # cur == e0: newly inserted edge, nothing held it before
            break
        pred_edge, cyc_forest = pred
        # cur previously lived in cyc_forest blocking pred_edge's insertion
        assert prev_forest == cyc_forest, (cur, prev_forest, cyc_forest)
        cur, into = pred_edge, cyc_forest


def max_edsts(g: Graph, k_hint: int | None = None):
    """Maximum set of edge-disjoint *spanning trees* of g.

    Returns (trees, nontree_edges).  Tries k from the combinatorial upper
    bound floor(m/(n-1)) downward; the first k whose packing yields k spanning
    forests is the answer (matroid union gives the maximum packing size, so
    if t trees exist the k=t run finds them).
    """
    if g.n <= 1:
        return [], set(g.edges)
    ub = g.m // (g.n - 1)
    if k_hint is not None:
        ub = min(ub, k_hint)
    for k in range(ub, 0, -1):
        forests = pack_forests(g, k)
        if all(len(f) == g.n - 1 for f in forests):
            trees = forests
            used = set().union(*trees) if trees else set()
            for t in trees:
                assert edges_are_spanning_tree(g.n, t)
            return trees, g.edges - used
    return [], set(g.edges)
