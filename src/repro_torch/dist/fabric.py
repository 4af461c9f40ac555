"""The stacked fabric: n data-parallel vertices held on one device.

Every per-vertex tensor carries a leading vertex dimension ``(n, ...)``;
row v is what vertex v of the reference's ``shard_map`` holds.  A
``jax.lax.ppermute`` becomes a gather into a zero-filled buffer, and
``jax.lax.axis_index`` an ``arange(n)``: a per-vertex table ``(n,)``
indexed by the axis index is a column mask ``(n, 1, ...)``.

Vertices nobody sends to receive **exact zeros**, as under ``ppermute``.
The executors rely on it: a wave whose every arrival accumulates into one
row is a single unmasked add, and a zero wire decodes to zeros.  So the
output is never built with ``torch.empty``.

Index tensors and masks are built once per permutation / table and kept
on the device, so a wave issues no host-to-device copy.
"""
from __future__ import annotations

import numpy as np
import torch


class StackedFabric:
    """``n`` vertices stacked along dim 0 of tensors on ``device``."""

    def __init__(self, n: int, device):
        self.n = int(n)
        self.device = torch.device(device)
        self._perms: dict = {}
        self._masks: dict = {}

    def axis_index(self):
        return torch.arange(self.n, device=self.device)

    def ppermute(self, x, perm):
        """``out[d] = x[s]`` for every ``(s, d)`` of ``perm``; every other
        row of ``out`` is zero."""
        if x.shape[0] != self.n:
            raise ValueError(f"expected {self.n} vertex rows, got "
                             f"{tuple(x.shape)}")
        out = torch.zeros_like(x)
        if perm:
            src, dst = self._perm(tuple(perm))
            out.index_copy_(0, dst, x.index_select(0, src))
        return out

    def column(self, table, ndim: int = 2):
        """A per-vertex bool table ``(n,)`` as a mask that broadcasts over
        an ``ndim``-dimensional stacked tensor: ``(n, 1, ..., 1)``."""
        table = np.asarray(table, bool)
        key = (table.tobytes(), ndim)
        hit = self._masks.get(key)
        if hit is None:
            hit = torch.as_tensor(table, device=self.device).reshape(
                (self.n,) + (1,) * (ndim - 1))
            self._masks[key] = hit
        return hit

    def _perm(self, perm):
        hit = self._perms.get(perm)
        if hit is None:
            src = torch.tensor([s for s, _ in perm], dtype=torch.long,
                               device=self.device)
            dst = torch.tensor([d for _, d in perm], dtype=torch.long,
                               device=self.device)
            hit = self._perms[perm] = (src, dst)
        return hit
