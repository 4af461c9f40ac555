"""EDST constructions on star products (paper Section 4).

Implements, with full verification:
  * Lemma 4.4.1    -- U-sets from non-tree subgraphs (+ swap repair so that
                      the non-tree subgraph provides enough escape capacity);
  * Thm 4.3.1      -- universal t1 + t2 - 2 construction (4.3.2 / 4.3.3);
  * Thm 4.5.1/4.5.2-- maximal t1 + t2 when r1 >= t1 and r2 >= t2
                      (Constructions 4.5.3, 4.5.4, 4.5.5, 4.5.6);
  * Thm 4.5.9      -- one-sided t1 + t2 - 1;
  * Thm 4.6.2      -- Property-4.6.1 route to t1 + t2 - 1 when r1 < t1 and
                      r2 < t2 (Constructions 4.6.4, 4.6.5, 4.6.6);
plus the auto-dispatcher used by the runtime and benchmarks.

All subgraph constructions go through Remark 4.5.7 (BFS tree-ification) and a
final verifier: every output tree is a spanning tree of the product and the
set is pairwise edge-disjoint.
"""
from __future__ import annotations

from dataclasses import dataclass

from .factor_edsts import EDSTSet, edsts_for
from .graph import (Graph, bfs_treeify, canon, directed_rooted,
                    edges_are_spanning_connected, edges_are_spanning_tree,
                    pairwise_edge_disjoint)
from .star import StarProduct


# ---------------------------------------------------------------------------
# Lemma 4.4.1: U-sets
# ---------------------------------------------------------------------------

def u_capacity(n: int, nontree: set) -> int:
    """Max |U| obtainable from non-tree subgraph N: sum over components of
    (|C| - 1) (leave one escape vertex per component)."""
    comps = Graph(n, nontree).components()
    return sum(len(c) - 1 for c in comps if len(c) > 1)


def choose_u_set(n: int, nontree: set, need: int) -> list[int]:
    """U of size ``need``: vertices with an N-path to a vertex outside U."""
    comps = [c for c in Graph(n, nontree).components() if len(c) > 1]
    u: list[int] = []
    for c in comps:
        take = min(len(c) - 1, need - len(u))
        u.extend(sorted(c)[:take])
        if len(u) == need:
            return u
    raise ValueError(f"U capacity {u_capacity(n, nontree)} < {need}")


def repair_for_u(factor: EDSTSet, need: int, max_iter: int = 200) -> EDSTSet:
    """Swap tree/non-tree edges (as in [16]) until U-capacity >= need.

    When N contains a cycle, a cycle edge (u, v) can replace an edge f on the
    u..v path of any tree T_i (T_i stays spanning); f joins N instead.  We
    greedily pick the swap that maximizes resulting capacity.
    """
    g, trees, nontree = factor.graph, [set(t) for t in factor.trees], set(factor.nontree)
    for _ in range(max_iter):
        if u_capacity(g.n, nontree) >= need:
            return EDSTSet(g, trees, nontree, factor.method + "+repair").verify()
        cyc = _find_cycle_edge(g.n, nontree)
        if cyc is None:
            break
        (u, v) = cyc
        best = None
        for ti, tr in enumerate(trees):
            path = _tree_path(g.n, tr, u, v)
            for f in zip(path, path[1:]):
                f = canon(*f)
                cand = (nontree - {canon(u, v)}) | {f}
                cap = u_capacity(g.n, cand)
                if best is None or cap > best[0]:
                    best = (cap, ti, f)
        if best is None:
            break
        _, ti, f = best
        trees[ti] = (trees[ti] - {f}) | {canon(u, v)}
        nontree = (nontree - {canon(u, v)}) | {f}
    cap = u_capacity(g.n, nontree)
    if cap >= need:
        return EDSTSet(g, trees, nontree, factor.method + "+repair").verify()
    raise ValueError(f"could not reach U capacity {need} (got {cap}) on {g.name}")


def _find_cycle_edge(n: int, edges: set):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in sorted(edges):
        ru, rv = find(u), find(v)
        if ru == rv:
            return (u, v)
        parent[ru] = rv
    return None


def _tree_path(n: int, tree: set, s: int, t: int) -> list[int]:
    from collections import deque
    adj = {}
    for a, b in tree:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    prev = {s: s}
    dq = deque([s])
    while dq:
        x = dq.popleft()
        if x == t:
            break
        for w in adj.get(x, ()):
            if w not in prev:
                prev[w] = x
                dq.append(w)
    assert t in prev, "disconnected tree"
    out = [t]
    while out[-1] != s:
        out.append(prev[out[-1]])
    return out[::-1]


# ---------------------------------------------------------------------------
# Shared construction pieces (paper edge sets, by equation number)
# ---------------------------------------------------------------------------

def _supernode_copy(sp: StarProduct, x: int, edges: set) -> set:
    """Edges of a factor-G_n edge set instantiated inside supernode x."""
    base = x * sp.nn
    return {canon(base + y, base + yp) for y, yp in edges}


def _all_bundles(sp: StarProduct, structure_edges) -> set:
    """Eq. (2)/(6)/(17): every product edge over each structure edge."""
    out = set()
    for x, xp in structure_edges:
        out.update(sp.bundle(x, xp))
    return out


def _sink_edges(sp: StarProduct, xbar1, sink_vertex: int) -> set:
    """Eq. (3)/(7)/(14): one product edge per directed X1 edge, incident to
    ``sink_vertex`` inside the sink supernode."""
    return {sp.cross_edge(x, xp, sink_vertex) for x, xp in xbar1}


# -- Construction 4.3.2 / 4.5.3: T_i via X_i and Y_1 --------------------------

def construct_A(sp: StarProduct, x_trees, y1: set, u_list) -> list[set]:
    out = []
    for xi, ui in zip(x_trees, u_list):
        t = _supernode_copy(sp, ui, y1) | _all_bundles(sp, xi)
        out.append(t)
    return out


# -- Construction 4.3.3 / 4.5.4: T'_i via Y_i and X_1 ------------------------

def construct_B(sp: StarProduct, xbar1, y_trees, v_list) -> list[set]:
    out = []
    for yi, vi in zip(y_trees, v_list):
        t = _sink_edges(sp, xbar1, vi)
        for g_ in range(sp.ns):
            t |= _supernode_copy(sp, g_, yi)
        out.append(t)
    return out


# -- Construction 4.5.5: extra tree via Y1@o, N_n elsewhere, sinks V_n \ U_n --

def construct_extra_nn(sp: StarProduct, xbar1, o: int, y1: set, nn_edges: set,
                       un: set) -> set:
    t = _supernode_copy(sp, o, y1)
    for x in range(sp.ns):
        if x != o:
            t |= _supernode_copy(sp, x, nn_edges)
    for v in range(sp.nn):
        if v not in un:
            t |= _sink_edges(sp, xbar1, v)
    return t


# -- Construction 4.5.6: extra tree via Y1@(V_s\U_s), N_s bundles, sink o' ----

def construct_extra_ns(sp: StarProduct, xbar1, o_prime: int, y1: set,
                       ns_edges: set, us: set) -> set:
    t = set()
    for x in range(sp.ns):
        if x not in us:
            t |= _supernode_copy(sp, x, y1)
    t |= _all_bundles(sp, ns_edges)
    t |= _sink_edges(sp, xbar1, o_prime)
    return t


# ---------------------------------------------------------------------------
# Result container + verification
# ---------------------------------------------------------------------------

@dataclass
class StarEDSTs:
    sp: StarProduct
    trees: list            # list[set[edge]] spanning trees of the product
    theorem: str
    t1: int
    t2: int
    r1: int
    r2: int

    @property
    def count(self) -> int:
        return len(self.trees)

    @property
    def upper_bound(self) -> int:
        g = self.sp.product()
        return g.m // (g.n - 1)

    @property
    def maximal(self) -> bool:
        return self.count == self.upper_bound

    def verify(self) -> "StarEDSTs":
        g = self.sp.product()
        assert pairwise_edge_disjoint(self.trees), "trees overlap"
        for t in self.trees:
            assert t <= g.edges, "tree uses non-product edge"
            assert edges_are_spanning_tree(g.n, t), "not a spanning tree"
        return self


def _treeify_all(sp: StarProduct, subgraphs, check: bool = True) -> list[set]:
    """Remark 4.5.7 over every construction subgraph.  ``check=False`` is
    the compositional fast path (:mod:`repro.core.product_schedule`): a
    subgraph with exactly N-1 edges is an exact spanning tree by the
    construction's own edge count (Construction A: (ns-1)*nn bundle edges
    + (nn-1) supernode edges; Construction B: (ns-1) sink edges +
    ns*(nn-1) supernode edges), so tree-ification is the identity and the
    O(N) spanning-connected scan is skipped.  Subgraphs with more edges
    still go through :func:`bfs_treeify`, whose own edge-count assert
    catches a non-spanning input; neither branch touches
    ``sp.product()``."""
    n = sp.n
    out = []
    for sub in subgraphs:
        if not check and len(sub) == n - 1:
            out.append(set(sub))
            continue
        if check:
            assert edges_are_spanning_connected(n, sub), \
                "subgraph not spanning"
        out.append(bfs_treeify(n, sub))
    return out


# ---------------------------------------------------------------------------
# Theorem-level constructions
# ---------------------------------------------------------------------------

def universal_edsts(sp: StarProduct, Es: EDSTSet, En: EDSTSet,
                    verify: bool = True) -> StarEDSTs:
    """Thm 4.3.1: t1 + t2 - 2 trees, no conditions."""
    t1, t2 = Es.t, En.t
    x_rest, y_rest = Es.trees[1:], En.trees[1:]
    u_list = list(range(min(sp.ns, t1 - 1 + 1)))[:t1 - 1]  # arbitrary distinct
    o = 0
    xbar1 = directed_rooted(Es.trees[0], o)
    v_list = list(range(t2 - 1))                            # arbitrary distinct
    trees = construct_A(sp, x_rest, En.trees[0], u_list)
    trees += construct_B(sp, xbar1, y_rest, v_list)
    res = StarEDSTs(sp, _treeify_all(sp, trees, check=verify), "4.3.1",
                    t1, t2, Es.r, En.r)
    return res.verify() if verify else res


def maximal_edsts(sp: StarProduct, Es: EDSTSet, En: EDSTSet,
                  verify: bool = True) -> StarEDSTs:
    """Thms 4.5.1/4.5.2: t1 + t2 trees when r1 >= t1 and r2 >= t2."""
    t1, t2 = Es.t, En.t
    Es = repair_for_u(Es, t1)
    En = repair_for_u(En, t2)
    us = choose_u_set(sp.ns, Es.nontree, t1)
    un = choose_u_set(sp.nn, En.nontree, t2)
    o, o_prime = us[0], un[0]
    u_list = [u for u in us if u != o][:t1 - 1]
    v_list = [v for v in un if v != o_prime][:t2 - 1]
    xbar1 = directed_rooted(Es.trees[0], o)
    y1 = En.trees[0]

    trees = construct_A(sp, Es.trees[1:], y1, u_list)
    trees += construct_B(sp, xbar1, En.trees[1:], v_list)
    trees.append(construct_extra_nn(sp, xbar1, o, y1, En.nontree, set(un)))
    trees.append(construct_extra_ns(sp, xbar1, o_prime, y1, Es.nontree, set(us)))
    res = StarEDSTs(sp, _treeify_all(sp, trees, check=verify), "4.5.1",
                    t1, t2, Es.r, En.r)
    return res.verify() if verify else res


def one_sided_edsts(sp: StarProduct, Es: EDSTSet, En: EDSTSet,
                    verify: bool = True) -> StarEDSTs:
    """Thm 4.5.9: t1 + t2 - 1 trees when r1 >= t1 or r2 >= t2."""
    t1, t2 = Es.t, En.t
    es_repaired = None
    if Es.r >= t1:
        try:
            es_repaired = repair_for_u(Es, t1)
        except ValueError:
            es_repaired = None
    if es_repaired is not None:
        # extra tree from N_s (Construction 4.5.6)
        Es = es_repaired
        us = choose_u_set(sp.ns, Es.nontree, t1)
        o = us[0]
        o_prime = 0
        u_list = [u for u in us if u != o][:t1 - 1]
        v_list = [v for v in range(sp.nn) if v != o_prime][:t2 - 1]
        xbar1 = directed_rooted(Es.trees[0], o)
        y1 = En.trees[0]
        trees = construct_A(sp, Es.trees[1:], y1, u_list)
        trees += construct_B(sp, xbar1, En.trees[1:], v_list)
        trees.append(construct_extra_ns(sp, xbar1, o_prime, y1,
                                        Es.nontree, set(us)))
    elif En.r >= t2:
        # extra tree from N_n (Construction 4.5.5)
        En = repair_for_u(En, t2)
        un = choose_u_set(sp.nn, En.nontree, t2)
        o_prime = un[0]
        o = 0
        u_list = [u for u in range(sp.ns) if u != o][:t1 - 1]
        v_list = [v for v in un if v != o_prime][:t2 - 1]
        xbar1 = directed_rooted(Es.trees[0], o)
        y1 = En.trees[0]
        trees = construct_A(sp, Es.trees[1:], y1, u_list)
        trees += construct_B(sp, xbar1, En.trees[1:], v_list)
        trees.append(construct_extra_nn(sp, xbar1, o, y1, En.nontree, set(un)))
    else:
        raise ValueError("one-sided construction needs r1 >= t1 or r2 >= t2")
    res = StarEDSTs(sp, _treeify_all(sp, trees, check=verify), "4.5.9",
                    t1, t2, Es.r, En.r)
    return res.verify() if verify else res


# ---------------------------------------------------------------------------
# Property 4.6.1 route (r1 < t1 and r2 < t2; all Cartesian products qualify)
# ---------------------------------------------------------------------------

def _subtree_vertices(children: dict, w: int) -> list[int]:
    out, stack = [], [w]
    while stack:
        v = stack.pop()
        out.append(v)
        stack.extend(children.get(v, ()))
    return out


def partition_y1(y1: set, o_prime: int, t2: int):
    """Edge bipartition (S1 bottom-forest, S2 top-subtree) of Y1 rooted at o'
    with |S1|, |S2| >= t2 - 2 + |I| and cut vertices I an antichain.

    Returns (S1, S2, V1, V2, I) or None."""
    directed = directed_rooted(y1, o_prime)
    children: dict = {}
    parent_edge = {}
    for p, c in directed:
        children.setdefault(p, []).append(c)
        parent_edge[c] = canon(p, c)
    nodes = [c for _, c in directed]

    import itertools
    # try antichains of growing size
    for size in (1, 2, 3):
        for cut in itertools.combinations(nodes, size):
            # cut vertices must have children (else no S1 edges at them) and
            # form an antichain (no cut vertex inside another's subtree)
            ok = all(children.get(w) for w in cut)
            for w in cut:
                if not ok:
                    break
                sub = set(_subtree_vertices(children, w))
                if any(w2 in sub for w2 in cut if w2 != w):
                    ok = False
            if not ok:
                continue
            s1, v1 = set(), set()
            for w in cut:
                subv = _subtree_vertices(children, w)
                v1.update(subv)
                for v in subv:
                    for c in children.get(v, ()):
                        s1.add(canon(v, c))
            s2 = set(y1) - s1
            i_set = set(cut)
            need = t2 - 2 + len(i_set)
            if len(s1) >= need and len(s2) >= need and s2:
                v2 = {a for e in s2 for a in e}
                # V(S1) = vertices incident to S1 edges; with cut vertices
                v1 = {a for e in s1 for a in e} | i_set
                if v1 & v2 != i_set:
                    continue
                return s1, s2, v1, v2, i_set
    return None


def check_property_461(sp: StarProduct, x_trees, v1: set, v2: set) -> bool:
    """f_(x,x')(V(Sj)) = V(Sj) for every edge of every X_i (Property 4.6.1)."""
    for xt in x_trees:
        for x, xp in xt:
            fmap = sp.f(x, xp)
            if {fmap[y] for y in v1} != v1 or {fmap[y] for y in v2} != v2:
                return False
    return True


def property_461_edsts(sp: StarProduct, Es: EDSTSet, En: EDSTSet,
                       verify: bool = True) -> StarEDSTs:
    """Thm 4.6.2: t1 + t2 - 1 trees under Property 4.6.1."""
    t1, t2 = Es.t, En.t
    o = 0
    o_prime = 0
    part = None
    for op_candidate in range(sp.nn):
        part = partition_y1(En.trees[0], op_candidate, t2)
        if part is not None:
            s1, s2, v1, v2, i_set = part
            if check_property_461(sp, Es.trees, v1, v2):
                o_prime = op_candidate
                break
            part = None
    if part is None:
        raise ValueError("Property 4.6.1 not satisfied for any Y1 rooting")
    s1, s2, v1, v2, i_set = part

    # balanced partition R1, R2 of V_s \ {o}
    rest = [x for x in range(sp.ns) if x != o]
    r1_set = set(rest[: len(rest) // 2 + len(rest) % 2])
    r2_set = set(rest) - r1_set
    if min(len(r1_set), len(r2_set)) < t1 - 1:
        raise ValueError("structure graph too small for balanced R1/R2")

    a_list = sorted(r1_set)[: t1 - 1]
    b_list = sorted(r2_set)[: t1 - 1]
    c_list = sorted(v1 - i_set)[: t2 - 1]
    d_list = sorted(v2 - i_set)[: t2 - 1]
    if len(c_list) < t2 - 1 or len(d_list) < t2 - 1:
        raise ValueError("S1/S2 vertex classes too small")

    xbar1 = directed_rooted(Es.trees[0], o)
    trees = []
    # Construction 4.6.4: T_i = S1@a_i + S2@b_i + all X_i bundles
    for xi, ai, bi in zip(Es.trees[1:], a_list, b_list):
        trees.append(_supernode_copy(sp, ai, s1) |
                     _supernode_copy(sp, bi, s2) |
                     _all_bundles(sp, xi))
    # Construction 4.6.5: T'_i = Y_i everywhere + split sinks c_i/d_i
    for yi, ci, di in zip(En.trees[1:], c_list, d_list):
        t = set()
        for g_ in range(sp.ns):
            t |= _supernode_copy(sp, g_, yi)
        for x, xp in xbar1:
            t.add(sp.cross_edge(x, xp, di if xp in r1_set else ci))
        trees.append(t)
    # Construction 4.6.6: T = Y1@o + S2@R1 + S1@R2 + class-sinks
    t = _supernode_copy(sp, o, set(En.trees[0]))
    for r in r1_set:
        t |= _supernode_copy(sp, r, s2)
    for r in r2_set:
        t |= _supernode_copy(sp, r, s1)
    for x, xp in xbar1:
        sinks = v1 if xp in r1_set else v2
        for sv in sinks:
            t.add(sp.cross_edge(x, xp, sv))
    trees.append(t)
    res = StarEDSTs(sp, _treeify_all(sp, trees, check=verify), "4.6.2",
                    t1, t2, Es.r, En.r)
    return res.verify() if verify else res


# ---------------------------------------------------------------------------
# Auto dispatcher
# ---------------------------------------------------------------------------

def star_edsts(sp: StarProduct, Es: EDSTSet | None = None,
               En: EDSTSet | None = None, strategy: str = "auto",
               verify: bool = True) -> StarEDSTs:
    """Theorem dispatch.  ``verify=False`` is the compositional fast path
    (used by :mod:`repro.core.product_schedule`): the constructions'
    guarantees are trusted -- no product-graph materialization, no
    per-tree spanning/disjointness scan -- and the compiled wave program
    is vetted by the static verifier instead."""
    Es = Es or edsts_for(sp.gs)
    En = En or edsts_for(sp.gn)
    t1, t2, r1, r2 = Es.t, En.t, Es.r, En.r
    if strategy == "universal":
        return universal_edsts(sp, Es, En, verify)
    if strategy == "maximal":
        return maximal_edsts(sp, Es, En, verify)
    if strategy == "one-sided":
        return one_sided_edsts(sp, Es, En, verify)
    if strategy == "property461":
        return property_461_edsts(sp, Es, En, verify)
    assert strategy == "auto", strategy

    if r1 >= t1 and r2 >= t2:
        try:
            return maximal_edsts(sp, Es, En, verify)
        except ValueError:
            pass
    if r1 >= t1 or r2 >= t2:
        try:
            return one_sided_edsts(sp, Es, En, verify)
        except ValueError:
            pass
    try:
        return property_461_edsts(sp, Es, En, verify)
    except ValueError:
        pass
    if t1 + t2 - 2 >= 1:
        return universal_edsts(sp, Es, En, verify)
    # degenerate fallback: a single BFS spanning tree of the product
    g = sp.product()
    return StarEDSTs(sp, [g.bfs_tree(0)], "bfs-fallback", t1, t2, r1, r2).verify()
