"""ZeRO-1 AdamW on EDST owner stripes (the reference's
``repro/optim/sharded.py``): optimizer state lives scattered.

:class:`ShardedAdamW` wraps the dense :class:`repro_torch.optim.adamw.AdamW`
so each vertex holds only its ``(k, smax)`` owner-stripe slice of the
first and second moments, the stripe geometry of
:func:`repro_torch.dist.striped.tree_reduce_scatter`.  A fabric's state is
one ``(rows, kmax, smax)`` tensor of its local vertices, row ``v - lo``
vertex v's: all n on the stacked fabric, and over the ranks of a
process group each rank's own block ``[lo, hi)`` (the reference's
``owner_stripe_spec`` layout, the leading owner axis split over the data
ranks), so no rank holds another's moments.  A zero1 train step
reduce-scatters the gradients, updates the params in the scattered
domain and allgathers the updated params only; the update reproduces the dense optimizer (bit for bit in
f32 up to the reassociation of the global norm):

  * clipping is a stripe-local partial sum of squares per vertex
    (:meth:`ShardedAdamW.partial_sumsq`) summed over the vertices (the
    reference's one scalar ``psum``); owner stripes partition the
    payload exactly and padding is zero, so the norm is the dense
    global norm;
  * :meth:`ShardedAdamW.update_stripes` is elementwise and mirrors
    ``AdamW.apply`` term for term, bias corrections included; padded
    entries carry ``p = g = decay = 0`` and stay exactly zero;
  * per-leaf weight decay (2D+ leaves only) becomes the flat
    :func:`decay_mask` vector over the ``tree_leaves`` order (sorted
    keys, as ``ravel_pytree``), cut into stripes beside the params.

Nothing here runs a collective; the train step (:mod:`repro_torch.dist.steps`)
and the fault runtime (:mod:`repro_torch.dist.fault`) own the
reduce-scatter and allgather.  Every update returns new tensors, so a
caller holding the previous state can roll a step back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .adamw import AdamW, tree_leaves


class ShardedOptState(NamedTuple):
    """ZeRO-1 optimizer state.  ``mu`` / ``nu`` are ``(rows, kmax,
    smax)`` f32 tensors whose leading dimension is the fabric's local
    owner vertices (all n on the stacked fabric); ``step`` is the count
    of committed updates."""
    step: int
    mu: torch.Tensor
    nu: torch.Tensor


def zero1_geometry(spec_or_runtime, size: int, fractions=None):
    """``(kmax, smax)`` of the padded stripe stack a zero1 step carries
    for a ``size``-element payload.  For a plain
    :class:`StripedCollectiveSpec` this is its own bind; for a
    :class:`repro_torch.dist.fault.FaultAwareAllreduce` the maximum over
    every precompiled failure-class entry, so one state shape serves all
    schedule ids."""
    from ..core.collectives import striped_tables
    if getattr(spec_or_runtime, "entries", None) is not None:
        return spec_or_runtime.zero1_geometry(size)
    fr = None if fractions is None else tuple(fractions)
    t = striped_tables(spec_or_runtime, size, fr)
    return spec_or_runtime.k, t.smax


def decay_mask(params, weight_decay: float) -> torch.Tensor:
    """The flat f32 weight-decay vector over the ``tree_leaves`` order:
    ``weight_decay`` on every element of a 2D+ leaf, 0 elsewhere (the
    per-leaf rule of ``AdamW.apply``), on the params' device."""
    leaves = tree_leaves(params)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([torch.full((p.numel(),),
                                 weight_decay if p.dim() >= 2 else 0.0,
                                 dtype=torch.float32, device=p.device)
                      for p in leaves])


@dataclass(frozen=True)
class ShardedAdamW:
    """Owner-stripe AdamW: the dense optimizer's math on ``(rows, kmax,
    smax)`` stripe stacks.  See the module docstring."""
    base: AdamW

    def init(self, ndp: int, kmax: int, smax: int,
             device="cpu") -> ShardedOptState:
        def zeros():
            return torch.zeros((ndp, kmax, smax), dtype=torch.float32,
                               device=device)
        return ShardedOptState(0, zeros(), zeros())

    def init_for(self, params, spec_or_runtime, ndp: int,
                 fractions=None, fabric=None) -> ShardedOptState:
        """State sized for ``params`` sharded over ``ndp`` owner vertices
        with the stripe geometry of a spec or a fault runtime, on the
        params' device: the rows of ``fabric``'s local vertices (a
        process-group rank's own block), or all ``ndp`` without one."""
        leaves = tree_leaves(params)
        size = sum(p.numel() for p in leaves)
        kmax, smax = zero1_geometry(spec_or_runtime, size, fractions)
        if fabric is not None and fabric.n != ndp:
            raise ValueError(f"fabric of {fabric.n} vertices for {ndp} "
                             "owner vertices")
        rows = ndp if fabric is None else fabric.rows
        return self.init(rows, kmax, smax, leaves[0].device)

    @staticmethod
    def partial_sumsq(owned_g) -> torch.Tensor:
        """Each local vertex's contribution to the squared global grad
        norm, ``(rows,)`` (stripe padding is zero and owner stripes
        partition the payload, so the square root of the sum over all n
        vertices is the dense norm)."""
        g32 = owned_g.float()
        return (g32 * g32).reshape(g32.shape[0], -1).sum(1)

    @torch.no_grad()
    def update_stripes(self, p, g, decay, mu, nu, step: int, gnorm):
        """One AdamW update on every vertex's stripes.

        ``p`` / ``g`` / ``decay`` / ``mu`` / ``nu`` are ``(rows, kmax,
        smax)`` f32 stripe stacks (params, mean grads, decay mask,
        moments); ``step`` is the post-increment count and ``gnorm`` the
        pre-clip global norm.  Returns new tensors
        ``(new_p, new_mu, new_nu, lr)``."""
        b = self.base
        dev = p.device
        scale = torch.clamp(b.clip_norm / (gnorm + 1e-9), max=1.0)
        g32 = g.float() * scale.to(g.dtype)
        lr = b.lr_fn(step)
        t = torch.tensor(float(step), dtype=torch.float32)
        c1 = 1 - torch.tensor(b.b1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(b.b2, dtype=torch.float32) ** t
        m = b.b1 * mu + (1 - b.b1) * g32
        v = b.b2 * nu + (1 - b.b2) * g32 * g32
        mhat = m / c1.to(dev)
        vhat = v / c2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + b.eps)
        new_p = p - lr.to(dev) * (delta + decay * p)
        return new_p, m, v, lr
