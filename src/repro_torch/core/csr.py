"""NumPy CSR adjacency + linear-time BFS helpers for the EDST hot path.

``Graph.adj()``'s list-of-lists and the dict-based BFS in the schedule
compiler are fine for toy fabrics but quadratic habits creep in around
them (``_best_root`` probed every vertex).  This module gives the compile
side an O(n + m) representation shared by :mod:`repro_torch.core.graph` and
:mod:`repro_torch.core.collectives`:

  * :class:`CSRAdjacency` -- immutable indptr/indices arrays over vertex
    ids ``0..n-1`` (both edge directions stored);
  * :meth:`CSRAdjacency.bfs_distances` -- frontier-vectorized BFS, every
    level a handful of NumPy gathers instead of a Python dict walk;
  * :func:`tree_center` -- the classic double-BFS: for a tree, the
    eccentricity of any vertex equals its distance to the farther of the
    two endpoints of a diametral path found by two sweeps, so the
    depth-minimizing root falls out of three BFS passes, O(n) total,
    instead of the n-pass probe.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CSRAdjacency:
    """Undirected adjacency in CSR form: neighbors of ``v`` are
    ``indices[indptr[v]:indptr[v + 1]]``."""
    n: int
    indptr: np.ndarray   # (n + 1,) int32
    indices: np.ndarray  # (2m,) int32

    @classmethod
    def from_edges(cls, n: int, edges) -> "CSRAdjacency":
        edges = np.asarray(sorted(edges), dtype=np.int64).reshape(-1, 2)
        if edges.size:
            src = np.concatenate([edges[:, 0], edges[:, 1]])
            dst = np.concatenate([edges[:, 1], edges[:, 0]])
        else:
            src = dst = np.zeros(0, np.int64)
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(n + 1, np.int32)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(n, indptr, dst.astype(np.int32))

    @property
    def degrees(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def bfs_distances(self, root: int) -> np.ndarray:
        """Hop distances from ``root``; -1 for unreachable vertices."""
        dist = np.full(self.n, -1, np.int32)
        dist[root] = 0
        frontier = np.array([root], np.int32)
        d = 0
        while frontier.size:
            starts = self.indptr[frontier]
            counts = self.indptr[frontier + 1] - starts
            total = int(counts.sum())
            if not total:
                break
            # flat gather of every frontier vertex's neighbor slice
            base = np.repeat(starts, counts)
            step = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
            nbrs = self.indices[base + step]
            nbrs = np.unique(nbrs[dist[nbrs] < 0])
            d += 1
            dist[nbrs] = d
            frontier = nbrs
        return dist

    def eccentricity(self, v: int) -> int:
        return int(self.bfs_distances(v).max())


def tree_center(n: int, edges) -> tuple[int, int]:
    """Depth-minimizing root of a tree and that minimum depth, via
    double-BFS: sweep to a diametral endpoint ``a``, sweep again to the
    opposite endpoint ``b``, and read every vertex's eccentricity off
    ``max(d(v, a), d(v, b))``.  Ties break to the smallest vertex id
    (matching the historical full probe).  O(n) for a spanning tree.
    """
    csr = CSRAdjacency.from_edges(n, edges)
    return csr_tree_center(csr)


def csr_tree_center(csr: CSRAdjacency) -> tuple[int, int]:
    if csr.n <= 1 or csr.indices.size == 0:
        return 0, 0
    a = int(np.argmax(csr.bfs_distances(0)))
    dist_a = csr.bfs_distances(a)
    b = int(np.argmax(dist_a))
    dist_b = csr.bfs_distances(b)
    ecc = np.maximum(dist_a, dist_b)
    root = int(np.argmin(ecc))  # argmin takes the first = smallest id
    return root, int(ecc[root])
