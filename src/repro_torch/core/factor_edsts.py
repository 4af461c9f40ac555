"""Maximal EDST sets for factor graphs (paper Table 4).

Explicit constructions where classical ones exist (Walecki decompositions for
complete graphs; trivial families), Roskind-Tarjan matroid union otherwise
(K_{q,q} [20], Paley [3], ER_q [17], MMS supernodes, IQ/BDF): the packing is
maximum, so it attains the Table-4 ``t`` whenever the cited existence results
hold -- asserted by tests across a parameter sweep.
"""
from __future__ import annotations

from dataclasses import dataclass

from .edst_rt import max_edsts
from .graph import Graph, canon, edges_are_spanning_tree


@dataclass
class EDSTSet:
    graph: Graph
    trees: list          # list[set[edge]]
    nontree: set         # non-tree edges N
    method: str

    @property
    def t(self) -> int:
        return len(self.trees)

    @property
    def r(self) -> int:
        return len(self.nontree)

    def verify(self) -> "EDSTSet":
        seen = set()
        for tr in self.trees:
            assert edges_are_spanning_tree(self.graph.n, tr)
            assert not (tr & seen), "trees share an edge"
            seen |= tr
        assert seen | self.nontree == self.graph.edges
        assert not (seen & self.nontree)
        return self


# -- explicit constructions ---------------------------------------------------

def _walecki_sequence(i: int, n2: int) -> list[int]:
    """Zigzag Hamiltonian sequence i, i+1, i-1, i+2, ... on Z_{n2} (n2 even)."""
    seq = [i % n2]
    for j in range(1, n2 // 2):
        seq.append((i + j) % n2)
        seq.append((i - j) % n2)
    seq.append((i + n2 // 2) % n2)
    return seq


def complete_graph_edsts(g: Graph) -> EDSTSet:
    """K_m: m even -> m/2 Hamiltonian paths (Walecki minus a vertex);
    m odd -> (m-1)/2 Hamiltonian cycles, each opened into a path."""
    m = g.n
    trees, nontree = [], set()
    if m % 2 == 0:
        n2 = m  # paths on Z_m directly?  Walecki: delete apex from K_{m+1}
        # K_{2n} = n Ham paths: zigzag sequences on Z_{2n}
        for i in range(m // 2):
            seq = _walecki_sequence(i, m)
            trees.append({canon(a, b) for a, b in zip(seq, seq[1:])})
    else:
        apex = m - 1
        n2 = m - 1
        for i in range(n2 // 2):
            seq = _walecki_sequence(i, n2)
            cyc = [apex] + seq + [apex]
            edges = {canon(a, b) for a, b in zip(cyc, cyc[1:])}
            # open the cycle: drop one edge into the non-tree pool
            drop = canon(apex, seq[-1])
            edges.discard(drop)
            nontree.add(drop)
            trees.append(edges)
    return EDSTSet(g, trees, nontree, "walecki").verify()


def cycle_edsts(g: Graph) -> EDSTSet:
    """C_n: one spanning tree (the cycle minus an edge), r = 1."""
    e = max(g.edges)
    return EDSTSet(g, [g.edges - {e}], {e}, "cycle").verify()


def tree_edsts(g: Graph) -> EDSTSet:
    """A graph that is already a tree (e.g. path): t=1, r=0."""
    return EDSTSet(g, [set(g.edges)], set(), "identity").verify()


def rt_edsts(g: Graph, k_hint: int | None = None) -> EDSTSet:
    trees, nontree = max_edsts(g, k_hint)
    return EDSTSet(g, trees, nontree, "roskind-tarjan").verify()


def edsts_for(g: Graph, method: str = "auto", k_hint: int | None = None) -> EDSTSet:
    """Dispatch on graph name/shape; falls back to Roskind-Tarjan."""
    if method == "rt":
        return rt_edsts(g, k_hint)
    name = g.name
    if name.startswith("K") and "," not in name and name[1:].isdigit():
        return complete_graph_edsts(g)
    if name.startswith("C") and name[1:].isdigit():
        return cycle_edsts(g)
    if name.startswith("L") and name[1:].isdigit():
        return tree_edsts(g)
    if g.m == g.n - 1 and g.is_connected():
        return tree_edsts(g)
    return rt_edsts(g, k_hint)
