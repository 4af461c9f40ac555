"""Factor graphs used by the paper (Appendix B, Table 4).

Every constructor returns a :class:`~repro_torch.core.graph.Graph` whose vertex
count / edge count match the paper's Table 4 rows; tests assert this for a
sweep of parameters.
"""
from __future__ import annotations

import functools
import itertools

from .gf import gf
from .graph import Graph, canon


# -- elementary graphs -------------------------------------------------------

def path(n: int) -> Graph:
    return Graph(n, {(i, i + 1) for i in range(n - 1)}, name=f"L{n}")


def cycle(n: int) -> Graph:
    if n < 3:
        raise ValueError("cycle needs n >= 3")
    return Graph(n, {(i, (i + 1) % n) for i in range(n)}, name=f"C{n}")


def complete(m: int) -> Graph:
    return Graph(m, set(itertools.combinations(range(m), 2)), name=f"K{m}")


def complete_bipartite(q: int, r: int | None = None) -> Graph:
    r = q if r is None else r
    return Graph(q + r, {(i, q + j) for i in range(q) for j in range(r)},
                 name=f"K{q},{r}")


def hypercube(d: int) -> Graph:
    n = 1 << d
    return Graph(n, {(v, v ^ (1 << b)) for v in range(n) for b in range(d)
                     if v < (v ^ (1 << b))}, name=f"Q{d}")


def circulant(n: int, diffs) -> Graph:
    edges = set()
    for v in range(n):
        for d in diffs:
            edges.add(canon(v, (v + d) % n))
    return Graph(n, edges, name=f"Circ{n}{sorted(set(d % n for d in diffs))}")


def petersen() -> Graph:
    outer = {(i, (i + 1) % 5) for i in range(5)}
    spokes = {(i, i + 5) for i in range(5)}
    inner = {(5 + i, 5 + (i + 2) % 5) for i in range(5)}
    return Graph(10, outer | spokes | inner, name="Petersen")


# -- Galois-field graphs ------------------------------------------------------

def paley(q: int) -> Graph:
    """Paley graph QR(q), q = 4k+1 prime power: x ~ y iff x-y is a nonzero QR."""
    if q % 4 != 1:
        raise ValueError("Paley graph needs q = 1 mod 4")
    F = gf(q)
    qr = F.quadratic_residues()
    edges = {canon(x, y) for x in range(q) for y in range(q)
             if x != y and F.sub(x, y) in qr}
    return Graph(q, edges, name=f"QR({q})")


@functools.lru_cache(maxsize=None)
def mms_connection_sets(q: int) -> tuple[frozenset, int, frozenset]:
    """Connection sets (X, c, X' = cX) for the MMS supernode Cayley graphs C(q).

    q = 4k+1: X = quadratic residues, X' = xi * X = non-residues
    (McKay-Miller-Siran).  q = 4k or 4k-1: Hafner [13] gives explicit sets; we
    recover valid ones by searching symmetric sets of the right size
    (|X| = (q - delta)/2 with q = 4k + delta) and a multiplier c with
    X' = cX such that H_q is connected with diameter 2 -- the defining MMS
    property.  The multiplier form guarantees Cayley(X) ~ Cayley(X') so both
    supernode sides are relabelings of the same supernode graph (needed for
    the star-product representation).  Sizes are tiny; the search is cached.
    """
    F = gf(q)
    if q % 4 == 1:
        x = frozenset(F.quadratic_residues())
        c = F.primitive
        xp = frozenset(F.mul(c, e) for e in x)
        assert xp == frozenset(set(range(1, q)) - set(x))
        return x, c, xp
    size = q // 2 if q % 4 == 0 else (q + 1) // 2
    # candidate symmetric subsets of GF(q)^* of given size, paired with a
    # multiplier c such that X' = cX also works
    pairs, singles = [], []
    seen = set()
    for a in range(1, q):
        if a in seen:
            continue
        na = F.neg(a)
        seen.add(a)
        seen.add(na)
        if na == a:
            singles.append((a,))
        else:
            pairs.append((a, na))
    units = pairs + singles
    for r in range(len(units) + 1):
        for combo in itertools.combinations(units, r):
            s = frozenset(x for unit in combo for x in unit)
            if len(s) != size:
                continue
            for c in range(2, q):
                xp = frozenset(F.mul(c, e) for e in s)
                h = _mms_graph(q, s, xp)
                if h.is_connected() and h.diameter() == 2:
                    return s, c, xp
    raise RuntimeError(f"no MMS connection sets found for q={q}")


def _mms_graph(q: int, x: frozenset, xp: frozenset) -> Graph:
    """Assemble H_q from connection sets (used by the search and slimfly())."""
    F = gf(q)
    # vertex (i, a, b) -> index i*q*q + a*q + b, i in {0,1}
    def vid(i, a, b):
        return i * q * q + a * q + b

    edges = set()
    for a in range(q):
        for b in range(q):
            for bp in range(q):
                if b < bp and F.sub(b, bp) in x:
                    edges.add(canon(vid(0, a, b), vid(0, a, bp)))
                if b < bp and F.sub(b, bp) in xp:
                    edges.add(canon(vid(1, a, b), vid(1, a, bp)))
    for xcoord in range(q):  # side 0 supernode index
        for m in range(q):   # side 1 supernode index
            for c in range(q):
                y = F.add(F.mul(m, xcoord), c)
                edges.add(canon(vid(0, xcoord, y), vid(1, m, c)))
    return Graph(2 * q * q, edges, name=f"H{q}")


def mms_supernode(q: int, side: int = 0) -> Graph:
    """C(q): the Cayley supernode graph of H_q (paper Table 4 rows 1-3)."""
    x, _, xp = mms_connection_sets(q)
    s = x if side == 0 else xp
    F = gf(q)
    edges = {canon(a, b) for a in range(q) for b in range(q)
             if a != b and F.sub(a, b) in s}
    return Graph(q, edges, name=f"C({q})s{side}")


def erdos_renyi_polarity(q: int) -> Graph:
    """ER_q: points of PG(2, q); u ~ v iff u . v = 0 (App. B.7)."""
    F = gf(q)
    # canonical projective points: last nonzero coordinate normalized to 1
    points = [(1, 0, 0)]
    points += [(x, 1, 0) for x in range(q)]
    points += [(x, y, 1) for x in range(q) for y in range(q)]
    assert len(points) == q * q + q + 1, (len(points), q)
    idx = {p: i for i, p in enumerate(points)}

    def dot(u, v):
        s = 0
        for a, b in zip(u, v):
            s = F.add(s, F.mul(a, b))
        return s

    edges = set()
    for i, u in enumerate(points):
        for j in range(i + 1, len(points)):
            if dot(u, points[j]) == 0:
                edges.add((i, j))
    g = Graph(len(points), edges, name=f"ER{q}")
    g.points = points  # type: ignore[attr-defined]
    g.point_index = idx  # type: ignore[attr-defined]
    return g


# -- PolarStar / BundleFly supernode stand-ins -------------------------------

def bdf(d: int) -> Graph:
    """Bermond-Delorme-Farhi graph of degree d: 2d vertices, d^2 edges.

    Implemented as the circulant on Z_{2d} with all odd differences (==
    K_{d,d} on the even/odd bipartition), matching the (v, e, degree,
    diameter 2) parameters of Table 4.  See DESIGN.md for the stand-in note.
    """
    return Graph(2 * d,
                 {canon(u, v) for u in range(2 * d) for v in range(2 * d)
                  if u < v and (u - v) % 2 == 1},
                 name=f"BDF({d})")


def inductive_quad(d: int) -> Graph:
    """IQ(d) stand-in: d-regular graph on 2d+2 vertices with d(d+1) edges.

    The true Inductive-Quad construction is internal to PolarStar [18]; the
    EDST theory consumes only (v, e, t, r, connectivity), which this circulant
    matches (verified by tests).  d must be 4m or 4m+3 per the paper.
    """
    if d % 4 not in (0, 3):
        raise ValueError("IQ(d) defined for d = 4m or 4m+3")
    n = 2 * d + 2
    if d % 2 == 0:
        diffs = list(range(1, d // 2 + 1))
    else:
        diffs = list(range(1, (d - 1) // 2 + 1)) + [n // 2]
    g = circulant(n, diffs)
    g.name = f"IQ({d})"
    assert g.m == d * (d + 1) and g.max_degree() == d, (g.m, d * (d + 1))
    return g
