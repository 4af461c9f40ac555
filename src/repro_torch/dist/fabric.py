"""The data-parallel fabrics: n vertices, held as rows of tensors.

Every per-vertex tensor carries a leading vertex dimension; row i is what
one vertex of the reference's ``shard_map`` holds.  Two fabrics keep the
same contract:

  * :class:`StackedFabric` holds all n vertices on one device, rows
    ``0..n-1``;
  * :class:`ProcessGroupFabric` spreads them over the ranks of a
    ``torch.distributed`` group (NCCL for CUDA tensors, gloo for CPU
    ones): rank r holds the contiguous block ``[lo_r, hi_r)``, block sizes
    differing by at most one.  With one vertex a rank this is the
    reference's ``shard_map`` layout; at world size 1 it is the stacked
    fabric, bit for bit.

A fabric's ``rows`` is its local vertex count and ``vertices`` the local
ids.  A ``jax.lax.ppermute`` becomes a gather into a zero-filled buffer for
the pairs whose two ends are local, and one ``batch_isend_irecv`` for the
pairs that cross ranks; ``jax.lax.axis_index`` is the local ids, and a
per-vertex table ``(n,)`` indexed by the axis index is a column mask
``(rows, 1, ...)`` (:meth:`column`).  The few values every rank must
agree on (a probe's bitmap, a step time, whether a background rebuild has
finished everywhere) go through :meth:`all_reduce` and :meth:`all_true`,
which are the identity on the stacked fabric.

Vertices nobody sends to receive **exact zeros**, as under ``ppermute``.
The executors rely on it: a wave whose every arrival accumulates into one
row is a single unmasked add, and a zero wire decodes to zeros.  So the
output is never built with ``torch.empty``.

Index tensors, exchange plans and masks are built once per permutation /
table and kept on the device, so a wave issues no host-to-device copy.

Under a profiler ``ppermute``'s zero fill, local gather and cross-rank
exchange run inside ``fabric/zero``, ``fabric/gather`` and ``fabric/p2p``
ranges (:mod:`repro_torch.telemetry.spans`).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry.spans import span

# the tensors each backend carries: a mismatch raises (nothing is staged
# through the host, nothing falls back)
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


@dataclass(frozen=True)
class WireCall:
    """One ``ppermute`` call: the wave it belongs to (the executor's
    ``edst/t*/w*/op`` label, ``None`` outside a wave), one vertex's wire
    dtype and element count, and the bytes of this rank's rows."""
    wave: str | None
    dtype: torch.dtype
    elems: int
    nbytes: int


_WIRE_LOG: list | None = None     # the calls, while a recording runs
_WAVE: str | None = None          # the wave the executor is in


@contextmanager
def record_wires():
    """Record every ``ppermute`` call made inside as a :class:`WireCall`
    into the list yielded (for :mod:`repro_torch.analysis.hlo`)."""
    global _WIRE_LOG
    prev, _WIRE_LOG = _WIRE_LOG, []
    try:
        yield _WIRE_LOG
    finally:
        _WIRE_LOG = prev


def recording() -> bool:
    return _WIRE_LOG is not None


@contextmanager
def in_wave(label: str):
    """Mark the ``ppermute`` calls made inside as wave ``label``'s."""
    global _WAVE
    prev, _WAVE = _WAVE, label
    try:
        yield
    finally:
        _WAVE = prev


def vertex_blocks(n: int, world: int) -> list:
    """``[(lo, hi)]`` a rank: n vertices in ``world`` contiguous blocks
    whose sizes differ by at most one (the larger blocks first)."""
    if not 1 <= world <= n:
        raise ValueError(f"world size {world} must be in [1, {n}] for a "
                         f"fabric of {n} vertices")
    base, extra = divmod(n, world)
    out, lo = [], 0
    for r in range(world):
        hi = lo + base + (r < extra)
        out.append((lo, hi))
        lo = hi
    return out


def world_size() -> int:
    """The default group's size, 1 when ``torch.distributed`` is not
    initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True)
class _Plan:
    """One permutation's exchange on this rank: the local gather's index
    tensors (None when no pair is local), then the sends and receives of
    the pairs that cross ranks, in the order of the sorted pairs."""
    src: torch.Tensor | None
    dst: torch.Tensor | None
    ops: tuple          # (is_send, local row, peer's global rank, tag)


class _BlockFabric:
    """Vertices ``[lo, hi)`` of ``n`` as rows of tensors on ``device``,
    this process being rank ``rank`` of ``world`` (``blocks``: every
    rank's ``(lo, hi)``; ``group``: the process group, None when
    stacked)."""
    world = 1
    rank = 0
    group = None

    def __init__(self, n: int, device, lo: int, hi: int):
        self.n = int(n)
        self.device = torch.device(device)
        self.lo, self.hi = int(lo), int(hi)
        self.rows = self.hi - self.lo
        self.vertices = range(self.lo, self.hi)
        self._perms: dict = {}
        self._masks: dict = {}

    def axis_index(self):
        return torch.arange(self.lo, self.hi, device=self.device)

    def column(self, table, ndim: int = 2):
        """A per-vertex bool table ``(n,)`` as a mask of the local rows
        that broadcasts over an ``ndim``-dimensional tensor of them:
        ``(rows, 1, ..., 1)``."""
        table = np.asarray(table, bool)
        key = (table.tobytes(), ndim)
        hit = self._masks.get(key)
        if hit is None:
            hit = torch.as_tensor(table[self.lo:self.hi],
                                  device=self.device).reshape(
                (self.rows,) + (1,) * (ndim - 1))
            self._masks[key] = hit
        return hit

    def ppermute(self, x, perm):
        """``out[d] = x[s]`` for every ``(s, d)`` of ``perm`` (global
        vertex ids) whose destination is local; every other row of
        ``out`` is zero."""
        if x.shape[0] != self.rows:
            raise ValueError(f"expected {self.rows} vertex rows, got "
                             f"{tuple(x.shape)}")
        self._check_device(x.device)
        if _WIRE_LOG is not None:
            _WIRE_LOG.append(WireCall(
                _WAVE, x.dtype, x[0].numel() if x.shape[0] else 0,
                x.numel() * x.element_size()))
        with span("fabric/zero"):
            out = torch.zeros_like(x)
        if perm:
            plan = self._perm(tuple(perm))
            if plan.src is not None:
                with span("fabric/gather"):
                    out.index_copy_(0, plan.dst, x.index_select(0, plan.src))
            if plan.ops:
                with span("fabric/p2p"):
                    self._exchange(x, out, plan.ops)
        return out

    def psum(self, x):
        """The sum over all n vertices of ``x`` (``(rows, ...)``), every
        local row holding it."""
        self._check_device(x.device)
        total = x.sum(0, keepdim=True)
        self._all_reduce(total)
        return total.expand_as(x)

    def owns(self, v: int) -> bool:
        return self.lo <= v < self.hi

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """``t`` (on the fabric's device) reduced in place over the ranks
        with ``op``; on the stacked fabric, which is one rank, as it is."""
        self._check_device(t.device)
        self._all_reduce(t, op)
        return t

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (over ranks one
        ``all_reduce`` MIN of a one-element tensor on the fabric's
        device)."""
        return bool(flag)

    def barrier(self) -> None:
        """Return once every rank has reached it (over ranks the host
        waits for the device's one-element ``all_reduce``)."""

    def gather(self, x):
        """Every rank's ``(rows, ...)`` block of ``x`` concatenated in
        vertex order, ``(n, ...)``, on every rank (one ``all_gather``); on
        the stacked fabric ``x`` itself."""
        return x

    def broadcast(self, t, vertex: int):
        """``t`` as the rank that holds ``vertex`` has it, on every rank
        (in place); on the stacked fabric ``t`` itself."""
        return t

    def _perm(self, perm):
        hit = self._perms.get(perm)
        if hit is None:
            local = [(s - self.lo, d - self.lo) for s, d in perm
                     if self.owns(s) and self.owns(d)]
            src = dst = None
            if local:
                src = torch.tensor([s for s, _ in local], dtype=torch.long,
                                   device=self.device)
                dst = torch.tensor([d for _, d in local], dtype=torch.long,
                                   device=self.device)
            hit = self._perms[perm] = _Plan(src, dst, self._cross(perm))
        return hit

    def _cross(self, perm) -> tuple:
        return ()

    def _exchange(self, x, out, ops) -> None:
        raise NotImplementedError

    def _all_reduce(self, t, op=dist.ReduceOp.SUM) -> None:
        pass

    def _check_device(self, device) -> None:
        pass


class StackedFabric(_BlockFabric):
    """``n`` vertices stacked along dim 0 of tensors on ``device``."""

    def __init__(self, n: int, device):
        super().__init__(n, device, 0, n)
        self.blocks = [(0, self.n)]


class ProcessGroupFabric(_BlockFabric):
    """``n`` vertices over the ranks of ``group`` (the default group when
    None): this rank's contiguous block of :func:`vertex_blocks`, as rows
    of tensors on ``device``, whose type must be the one the group's
    backend carries (:data:`BACKEND_DEVICE`)."""

    def __init__(self, n: int, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupFabric needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.blocks = vertex_blocks(int(n), self.world)
        backend = str(dist.get_backend(group))
        if backend not in BACKEND_DEVICE:
            raise ValueError(f"backend {backend!r} not in "
                             f"{tuple(BACKEND_DEVICE)}")
        self.backend = backend
        super().__init__(n, device, *self.blocks[self.rank])
        self._check_device(self.device)
        self._owner = np.repeat(np.arange(self.world),
                                [hi - lo for lo, hi in self.blocks])
        if backend == "nccl" and self.world > 1:
            # NCCL wants every rank in a group's first call; a later
            # batch_isend_irecv may then leave out ranks with no pair
            dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    def _check_device(self, device) -> None:
        want = BACKEND_DEVICE[self.backend]
        if device.type != want:
            raise ValueError(f"the {self.backend} group carries {want} "
                             f"tensors, got one on {device}")

    def _cross(self, perm) -> tuple:
        """This rank's sends and receives of the pairs whose ends lie on
        two ranks, in the order of the sorted pairs (the same on every
        rank, so NCCL matches them in turn); gloo matches each by its
        tag, the source vertex (unique in a permutation)."""
        ops = []
        for s, d in sorted(perm):
            if self.owns(s) != self.owns(d):
                send = self.owns(s)
                peer = int(self._owner[d if send else s])
                if self.group is not None:
                    peer = dist.get_global_rank(self.group, peer)
                ops.append((send, (s if send else d) - self.lo, peer, s))
        return tuple(ops)

    def _exchange(self, x, out, ops) -> None:
        p2p = [dist.P2POp(dist.isend, x[row].contiguous(), peer, self.group,
                          tag) if send else
               dist.P2POp(dist.irecv, out[row], peer, self.group, tag)
               for send, row, peer, tag in ops]
        for req in dist.batch_isend_irecv(p2p):
            req.wait()

    def _all_reduce(self, t, op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(t, op=op, group=self.group)

    def all_true(self, flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(self.all_reduce(t, dist.ReduceOp.MIN).item())

    def barrier(self) -> None:
        self.all_true(True)

    def gather(self, x):
        self._check_device(x.device)
        return gather_blocks(x, [hi - lo for lo, hi in self.blocks],
                             self.group)

    def broadcast(self, t, vertex: int):
        self._check_device(t.device)
        src = int(self._owner[vertex])
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast(t, src=src, group=self.group)
        return t


def gather_blocks(x, counts, group=None):
    """Concatenate every rank's ``(counts[r], ...)`` block of rows in rank
    order on every rank of ``group``: one ``all_gather`` of the blocks,
    each zero-padded to the largest count."""
    width = max(counts)
    x = x.contiguous()
    if x.shape[0] < width:
        pad = x.new_zeros((width - x.shape[0],) + tuple(x.shape[1:]))
        x = torch.cat([x, pad])
    parts = [torch.empty_like(x) for _ in counts]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])
