"""Lightweight undirected simple-graph type used by all EDST machinery.

Vertices are integers 0..n-1.  Edges are canonical ``(u, v)`` tuples with
``u < v``.  The class is immutable-ish (treat as frozen after construction);
every EDST routine returns *new* edge sets rather than mutating graphs.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


def canon(u: int, v: int) -> tuple[int, int]:
    return (u, v) if u < v else (v, u)


@dataclass
class Graph:
    n: int
    edges: set = field(default_factory=set)  # set[tuple[int,int]] canonical
    name: str = "G"

    def __post_init__(self):
        self.edges = {canon(*e) for e in self.edges}
        for u, v in self.edges:
            if u == v:
                raise ValueError(f"self-loop {u}")
            if not (0 <= u < self.n and 0 <= v < self.n):
                raise ValueError(f"edge {(u, v)} out of range n={self.n}")
        self._adj = None
        self._csr = None

    # -- basic accessors ----------------------------------------------------
    @property
    def m(self) -> int:
        return len(self.edges)

    def adj(self) -> list:
        if self._adj is None:
            a = [[] for _ in range(self.n)]
            for u, v in self.edges:
                a[u].append(v)
                a[v].append(u)
            self._adj = a
        return self._adj

    def csr(self):
        """CSR adjacency (:class:`repro_torch.core.csr.CSRAdjacency`), cached;
        the linear-time representation behind ``diameter`` and the
        schedule compiler's center finding."""
        if self._csr is None:
            from .csr import CSRAdjacency
            self._csr = CSRAdjacency.from_edges(self.n, self.edges)
        return self._csr

    def degree(self, v: int) -> int:
        return len(self.adj()[v])

    def max_degree(self) -> int:
        return max((len(x) for x in self.adj()), default=0)

    def has_edge(self, u: int, v: int) -> bool:
        return canon(u, v) in self.edges

    # -- algorithms ----------------------------------------------------------
    def components(self) -> list:
        seen = [False] * self.n
        comps = []
        adj = self.adj()
        for s in range(self.n):
            if seen[s]:
                continue
            comp = [s]
            seen[s] = True
            dq = deque([s])
            while dq:
                u = dq.popleft()
                for w in adj[u]:
                    if not seen[w]:
                        seen[w] = True
                        comp.append(w)
                        dq.append(w)
            comps.append(comp)
        return comps

    def is_connected(self) -> bool:
        return self.n <= 1 or len(self.components()) == 1

    def bfs_tree(self, root: int = 0) -> set:
        """Edges of a BFS spanning tree of *this graph's* component of root."""
        adj = self.adj()
        seen = [False] * self.n
        seen[root] = True
        dq = deque([root])
        tree = set()
        while dq:
            u = dq.popleft()
            for w in adj[u]:
                if not seen[w]:
                    seen[w] = True
                    tree.add(canon(u, w))
                    dq.append(w)
        return tree

    def diameter(self) -> int:
        """Exact diameter via n CSR-BFS passes (each pass O(n + m))."""
        csr = self.csr()
        best = 0
        for s in range(self.n):
            dist = csr.bfs_distances(s)
            d = int(dist.max())
            if (dist < 0).any():
                return -1  # disconnected
            best = max(best, d)
        return best

    def subgraph_of_edges(self, edges, name: str = "sub") -> "Graph":
        return Graph(self.n, set(edges), name=name)

    def without_edges(self, edges) -> "Graph":
        drop = {canon(*e) for e in edges}
        return Graph(self.n, self.edges - drop, name=self.name + "-minus")

    def copy(self) -> "Graph":
        return Graph(self.n, set(self.edges), name=self.name)


# ---------------------------------------------------------------------------
# helpers on plain edge sets (used for trees that live inside a bigger graph)
# ---------------------------------------------------------------------------

def edges_are_spanning_tree(n: int, edges) -> bool:
    edges = {canon(*e) for e in edges}
    if len(edges) != n - 1:
        return False
    return _spans(n, edges)


def edges_are_spanning_connected(n: int, edges) -> bool:
    """Spanning + connected (may contain cycles)."""
    return _spans(n, {canon(*e) for e in edges})


def _spans(n: int, edges) -> bool:
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    comps = n
    for u, v in edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            comps -= 1
    return comps == 1


def bfs_treeify(n: int, edges, root: int = 0) -> set:
    """Remark 4.5.7: reduce a connected spanning edge set to a spanning tree."""
    g = Graph(n, {canon(*e) for e in edges})
    tree = g.bfs_tree(root)
    assert len(tree) == n - 1, "subgraph was not spanning/connected"
    return tree


def pairwise_edge_disjoint(tree_list) -> bool:
    seen = set()
    for t in tree_list:
        for e in t:
            e = canon(*e)
            if e in seen:
                return False
            seen.add(e)
    return True


def directed_rooted(tree_edges, root: int):
    """Orient a tree away from ``root``: returns list of (parent, child)."""
    adj = {}
    for u, v in tree_edges:
        adj.setdefault(u, []).append(v)
        adj.setdefault(v, []).append(u)
    out = []
    seen = {root}
    dq = deque([root])
    while dq:
        u = dq.popleft()
        for w in adj.get(u, ()):
            if w not in seen:
                seen.add(w)
                out.append((u, w))
                dq.append(w)
    assert len(out) == len(set(map(tuple, (canon(*e) for e in tree_edges)))), \
        "tree not connected from root"
    return out


def tree_depth_levels(tree_edges, root: int):
    """BFS levels of a rooted tree: list of lists of (parent, child) per depth."""
    adj = {}
    for u, v in tree_edges:
        adj.setdefault(u, []).append(v)
        adj.setdefault(v, []).append(u)
    levels = []
    seen = {root}
    frontier = [root]
    while frontier:
        nxt, lvl = [], []
        for u in frontier:
            for w in adj.get(u, ()):
                if w not in seen:
                    seen.add(w)
                    lvl.append((u, w))
                    nxt.append(w)
        if lvl:
            levels.append(lvl)
        frontier = nxt
    return levels
