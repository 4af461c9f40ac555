"""Named network topologies as star products (paper Section 2.4).

Every topology is returned as a :class:`StarProduct`, so the Section-4 EDST
constructions apply uniformly.  ``edst_set_for`` converts a star-product EDST
result back into an :class:`EDSTSet`, enabling the *recursive* use the paper
highlights in Sec. 4.1 (BundleFly's structure graph H_q is itself a star
product).
"""
from __future__ import annotations

import functools

from . import factor_graphs as fg
from .edst_star import StarEDSTs, star_edsts
from .factor_edsts import EDSTSet, edsts_for
from .gf import gf
from .graph import Graph
from .star import StarProduct, cartesian, shift_star, star_with


# ---------------------------------------------------------------------------
# Slim Fly (McKay-Miller-Siran H_q): K_{q,q} * C(q)   [paper Ex. 2.4.2]
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def slimfly(q: int) -> StarProduct:
    """H_q as an explicit star product over GF(q).

    Structure graph: K_{q,q} with side-0 vertices x in [0,q) and side-1
    vertices q+m.  Supernode: Cayley(GF(q), X).  Side-1 supernodes use the
    relabeling c = mult * u (X' = mult * X), so the bijection on structure
    edge (x, q+m) maps supernode coordinate y to u = mult^{-1} (y - m x),
    realizing the MMS adjacency y = m x + c.
    """
    F = gf(q)
    x_set, mult, _ = fg.mms_connection_sets(q)
    gs = fg.complete_bipartite(q)
    gn = fg.mms_supernode(q, side=0)
    minv = F.inv(mult)

    def bij(u, v):
        # canonical edge: u = x in [0,q), v = q + m
        x, m = u, v - q
        return tuple(F.mul(minv, F.sub(y, F.mul(m, x))) for y in range(q))

    sp = star_with(gs, gn, bij, name=f"SlimFly(q={q})")
    return sp


# ---------------------------------------------------------------------------
# BundleFly: H_q * QR(a)        [paper Ex. 2.4.3]
# ---------------------------------------------------------------------------

def bundlefly(q: int, a: int) -> StarProduct:
    if a % 4 != 1:
        raise ValueError("BundleFly supernode QR(a) needs a = 4k+1")
    hq = slimfly(q).product()
    sn = fg.paley(a)
    sp = shift_star(hq, sn, name=f"BundleFly(q={q},a={a})")
    return sp


# ---------------------------------------------------------------------------
# PolarStar: ER_q * QR(a)  or  ER_q * IQ(d)    [paper Ex. 2.4.4]
# ---------------------------------------------------------------------------

def polarstar(q: int, supernode: str = "qr", param: int | None = None) -> StarProduct:
    er = fg.erdos_renyi_polarity(q)
    if supernode == "qr":
        a = param if param is not None else 5
        sn = fg.paley(a)
    elif supernode == "iq":
        d = param if param is not None else 4
        sn = fg.inductive_quad(d)
    else:
        raise ValueError(supernode)
    return shift_star(er, sn, name=f"PolarStar(q={q},{supernode}{param})")


# ---------------------------------------------------------------------------
# Cartesian families: HyperX, mesh, torus    [paper Ex. 2.4.1]
# ---------------------------------------------------------------------------

def hyperx(lengths) -> StarProduct:
    """(L, {S_1..S_L}, 0, 0) HyperX: iterated Cartesian product of complete
    graphs; the structure graph of each level is K_{S_L}."""
    lengths = list(lengths)
    if len(lengths) < 2:
        raise ValueError("HyperX needs >= 2 dimensions")
    gn: Graph = fg.complete(lengths[0])
    sp = None
    for s in lengths[1:]:
        sp = cartesian(fg.complete(s), gn,
                       name=f"HyperX{lengths}" if s == lengths[-1] else None)
        gn = sp.product()
    return sp


def torus(dims) -> StarProduct:
    """n-D torus with ROW-MAJOR vertex ids (first dim slowest): vertex
    (i0..ik) has id i0*prod(d1..dk) + ... -- matches jax mesh flattening."""
    dims = list(dims)
    if len(dims) < 2:
        raise ValueError("torus needs >= 2 dims")

    def g(d):
        return fg.cycle(d) if d > 2 else fg.path(d)

    gn: Graph = g(dims[-1])
    sp = None
    for d in dims[-2::-1]:
        sp = cartesian(g(d), gn, name=f"Torus{dims}")
        gn = sp.product()
    return sp


def mesh_nd(dims) -> StarProduct:
    dims = list(dims)
    if len(dims) < 2:
        raise ValueError("mesh needs >= 2 dims")
    gn: Graph = fg.path(dims[-1])
    sp = None
    for d in dims[-2::-1]:
        sp = cartesian(fg.path(d), gn, name=f"Mesh{dims}")
        gn = sp.product()
    return sp


def device_topology(shape, wrap: bool = True) -> StarProduct:
    """The ICI graph of a TPU slice of logical shape ``shape`` (a torus for
    wrap=True, as on v5e pods; a mesh otherwise).  Vertex ids are row-major
    over ``shape``, matching the flattened jax mesh-axis index."""
    shape = [int(s) for s in shape if int(s) > 1]
    if len(shape) == 1:
        shape = [1] + shape
    return torus(shape) if wrap else mesh_nd(shape)


# ---------------------------------------------------------------------------
# EDST plumbing: factor EDSTs for any topology (recursive for star products)
# ---------------------------------------------------------------------------

def edst_set_for(sp_or_graph, strategy: str = "auto") -> EDSTSet:
    """EDSTSet for a topology: star-product construction when available
    (recursively), Roskind-Tarjan otherwise."""
    if isinstance(sp_or_graph, StarProduct):
        res = star_edsts(sp_or_graph, strategy=strategy)
        return star_result_to_set(res)
    return edsts_for(sp_or_graph)


def star_result_to_set(res: StarEDSTs) -> EDSTSet:
    g = res.sp.product()
    used = set().union(*res.trees) if res.trees else set()
    return EDSTSet(g, res.trees, g.edges - used,
                   f"star-{res.theorem}").verify()


def topology_edsts(sp: StarProduct, strategy: str = "auto",
                   structure_set: EDSTSet | None = None,
                   supernode_set: EDSTSet | None = None) -> StarEDSTs:
    """star_edsts with recursive handling of star-product structure graphs.

    BundleFly's structure graph is H_q; passing its star-construction EDSTs
    (rather than RT-found ones) exercises the paper's recursive maximality
    argument (Sec. 4.1)."""
    return star_edsts(sp, structure_set, supernode_set, strategy=strategy)
