"""The star product G* = G_s * G_n (paper Def. 2.3.1).

Vertices of the product are ``(x, y)`` encoded as ``x * |V_n| + y``.  For every
*directed* structure edge ``(x, x')`` a bijection ``f_(x,x')`` on supernode
vertices is stored (with ``f_(x',x) = f_(x,x')^{-1}`` enforced).  The Cartesian
product is the special case of identity bijections.
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass, field

from .graph import Graph, canon


def _invert(perm: tuple) -> tuple:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


@dataclass
class StarProduct:
    gs: Graph                     # structure graph
    gn: Graph                     # supernode graph
    bijections: dict = field(default_factory=dict)  # (x, x') -> tuple perm
    name: str = "star"

    def __post_init__(self):
        ident = tuple(range(self.gn.n))
        full = {}
        for u, v in self.gs.edges:
            p = self.bijections.get((u, v))
            if p is None:
                pinv = self.bijections.get((v, u))
                p = _invert(tuple(pinv)) if pinv is not None else ident
            p = tuple(p)
            assert sorted(p) == list(range(self.gn.n)), f"not a bijection on {(u, v)}"
            full[(u, v)] = p
            full[(v, u)] = _invert(p)
        self.bijections = full
        self._product = None
        self._key = None

    # -- indexing -------------------------------------------------------------
    @property
    def ns(self) -> int:
        return self.gs.n

    @property
    def nn(self) -> int:
        return self.gn.n

    @property
    def n(self) -> int:
        return self.gs.n * self.gn.n

    def vid(self, x: int, y: int) -> int:
        return x * self.gn.n + y

    def coords(self, v: int) -> tuple[int, int]:
        return divmod(v, self.gn.n)

    def cache_key(self) -> tuple:
        """Stable value key of the product (factor edge sets + bijections):
        two ``StarProduct`` objects with equal keys define the same product
        graph vertex-for-vertex.  Computed once and memoized -- the
        compositional schedule compiler (:mod:`repro.core.product_schedule`)
        keys its composed-schedule and spec caches on it, so elastic
        rescales and fault-runtime rebuilds that land on an
        already-compiled fabric reuse the schedule instead of recompiling.
        """
        if self._key is None:
            bij = tuple(sorted(
                (e, p) for e, p in self.bijections.items() if e[0] < e[1]))
            self._key = (self.ns, self.nn, frozenset(self.gs.edges),
                         frozenset(self.gn.edges), bij)
        return self._key

    def f(self, x: int, xp: int) -> tuple:
        """Bijection mapping supernode-x coordinates to supernode-xp coordinates."""
        return self.bijections[(x, xp)]

    def finv(self, x: int, xp: int) -> tuple:
        return self.bijections[(xp, x)]

    # -- product graph ----------------------------------------------------------
    def product(self) -> Graph:
        if self._product is None:
            edges = set()
            for x in range(self.ns):
                base = x * self.nn
                for y, yp in self.gn.edges:
                    edges.add(canon(base + y, base + yp))
            for x, xp in self.gs.edges:
                fmap = self.f(x, xp)
                for y in range(self.nn):
                    edges.add(canon(self.vid(x, y), self.vid(xp, fmap[y])))
            self._product = Graph(self.n, edges, name=self.name)
        return self._product

    # -- structure-edge expansion (used by the EDST constructions) --------------
    def bundle(self, x: int, xp: int):
        """All |V_n| product edges realizing structure edge (x, x')."""
        fmap = self.f(x, xp)
        return [canon(self.vid(x, y), self.vid(xp, fmap[y])) for y in range(self.nn)]

    def cross_edge(self, x: int, xp: int, sink_vertex: int):
        """The unique product edge over (x, x') whose endpoint in supernode x'
        is ``sink_vertex`` (paper's edge sets (3)/(7)/(11)/(14)...)."""
        finv = self.finv(x, xp)
        return canon(self.vid(x, finv[sink_vertex]), self.vid(xp, sink_vertex))


# -- constructors -------------------------------------------------------------

def cartesian(gs: Graph, gn: Graph, name: str | None = None) -> StarProduct:
    return StarProduct(gs, gn, {}, name=name or f"{gs.name}x{gn.name}")


def star_with(gs: Graph, gn: Graph, bij_fn, name: str = "star") -> StarProduct:
    """bij_fn(x, x') -> permutation tuple for each canonical structure edge."""
    bij = {(u, v): tuple(bij_fn(u, v)) for u, v in gs.edges}
    return StarProduct(gs, gn, bij, name=name)


def random_star(gs: Graph, gn: Graph, seed: int = 0, name: str = "rand-star") -> StarProduct:
    rng = _random.Random(seed)

    def mk(u, v):
        p = list(range(gn.n))
        rng.shuffle(p)
        return tuple(p)

    return star_with(gs, gn, mk, name=name)


def block_preserving_star(gs: Graph, gn: Graph, v1: set, v2: set,
                          seed: int = 0,
                          name: str = "blk-star") -> StarProduct:
    """A NON-Cartesian star product satisfying Property 4.6.1: every
    bijection permutes within the vertex classes ``v1`` and ``v2`` (and
    fixes their intersection), so f(V(S1)) = V(S1) and f(V(S2)) = V(S2)
    for partitions with those vertex classes.  Demonstrates the paper's
    remark that "some star products" (not just Cartesian ones) admit the
    Thm 4.6.2 construction."""
    import random as _r
    rng = _r.Random(seed)
    inter = set(v1) & set(v2)
    only1 = sorted(set(v1) - inter)
    only2 = sorted(set(v2) - inter)

    def mk(u, v):
        p = list(range(gn.n))
        a = only1[:]
        rng.shuffle(a)
        for src, dst in zip(only1, a):
            p[src] = dst
        b = only2[:]
        rng.shuffle(b)
        for src, dst in zip(only2, b):
            p[src] = dst
        return tuple(p)

    return star_with(gs, gn, mk, name=name)


def shift_star(gs: Graph, gn: Graph, name: str = "shift-star") -> StarProduct:
    """Cyclic-shift bijections: f_(x,x')(y) = y + (x + x') mod |V_n|.

    A cheap structured family of non-identity bijections (used for BundleFly /
    PolarStar assemblies where the P*/R* internals are out of scope)."""
    nn = gn.n

    def mk(u, v):
        s = (u + v) % nn
        return tuple((y + s) % nn for y in range(nn))

    return star_with(gs, gn, mk, name=name)
