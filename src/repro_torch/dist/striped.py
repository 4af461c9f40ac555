"""Striped EDST collectives on a stacked fabric: reduce-scatter, allgather,
and the composed bandwidth-optimal allreduce (the reference's
``repro.dist.striped``).

The engines in :mod:`repro_torch.dist.tree_allreduce` ship the full
m-sized chunk along every tree edge.  This module executes the
:class:`repro_torch.core.collectives.StripedCollectiveSpec` program
instead: each vertex owns one stripe of every tree's chunk (DFS-preorder
slots, largest-remainder ``chunk_sizes`` widths), reduce-scatter waves
move partial sums so every edge carries only the stripes owned on the far
side of it, and allgather waves fan the finished stripes back out as a
pure gather.  Per-wave wire bytes drop from ``m`` to
``ceil(m/n) * slots-in-window`` at roughly twice the wave count.

Execution model: state is the ``(n, k, mrow)`` stack of every vertex's
padded chunk rows.  Every window is one *circular* interval of a row (a
subtree and its complement are both contiguous mod n), so it is at most
two contiguous slices, and each wave runs as a host loop over the
vertices: a sender copies its window (the wave's wire width, from its
offset) into its row of the payload, the fabric moves the payload, and a
receiver adds (reduce-scatter, through the tree-combine kernel) or copies
(allgather) the arrival's true length into its own window.  The
reference rolls whole rows and adds a one-hot ``(k, mrow)`` contribution
under a circular mask; the elements it covers outside the window gain
exact zeros there, so touching only the window gives the same sums
without an index or a mask the size of the state.

With ``quantize=True`` reduce-scatter hops obey the ``codec`` policy
(int8 wire via the codec kernels, one scale per vertex per hop) and
allgather hops always take the int8 wire when the codec is enabled.
"""
from __future__ import annotations

import torch

from ..core.collectives import REDUCE, StripedCollectiveSpec, striped_tables
from .tree_allreduce import (_FLOATS, _REDUCE_WIRE, _acc, _check_fabric,
                             _check_fractions, _note_trace, _rows_out,
                             _scope, _send, resolve_codec)


def _normalize(fractions):
    return None if fractions is None else tuple(fractions)


def _wires(quantize: bool, codec, dtype, device) -> tuple:
    """(reduce-scatter wire, allgather wire) for the codec policy."""
    codec = resolve_codec(codec, device) if quantize else "off"
    if dtype not in _FLOATS:
        codec = "off"       # integer payloads always travel verbatim
    return _REDUCE_WIRE[codec], ("q8" if codec != "off" else None)


def _windows(off: int, length: int, mrow: int):
    """The circular window ``[off, off + length) mod mrow`` as at most two
    ``(row offset, window offset, width)`` slices."""
    first = min(length, mrow - off)
    out = [(off, 0, first)]
    if length > first:
        out.append((0, first, length - first))
    return out


def _rows_in(flat, sizes, mrow):
    """The padded ``(n, k, mrow)`` state: tree j's chunk of every vertex
    (the last may run short of its size), zero past it.  Filled in place:
    stacking ``_rows_of``'s rows would hold the state twice."""
    n, size = flat.shape
    state = torch.zeros((n, len(sizes), mrow), dtype=flat.dtype,
                        device=flat.device)
    off = 0
    for j, s in enumerate(sizes):
        have = max(0, min(s, size - off))
        state[:, j, :have] = flat[:, off:off + have]
        off += s
    return state


def _run_wave(state, bw, fabric, rs_wire, ag_wire):
    """Execute ONE bound striped wave on the ``(n, k, mrow)`` state, in
    place.  Every sender ships ``bw.wire`` elements from its window's
    offset (the reference's ``roll(row, -off)[:wire]``: a codec's scale
    sees the same elements); vertices nobody sends to receive zeros and
    land nothing."""
    n, _, mrow = state.shape
    payload = torch.zeros((n, bw.wire), dtype=state.dtype,
                          device=state.device)
    for s, _ in bw.perm:
        j, off = int(bw.send_tree[s]), int(bw.send_off[s])
        for lo, at, width in _windows(off, bw.wire, mrow):
            payload[s, at:at + width] = state[s, j, lo:lo + width]
    recv = _send(payload, fabric, bw.perm,
                 rs_wire if bw.op == REDUCE else ag_wire)
    del payload
    for _, d in bw.perm:
        j, off = int(bw.recv_tree[d]), int(bw.recv_off[d])
        for lo, at, width in _windows(off, int(bw.recv_len[d]), mrow):
            window = state[d, j, lo:lo + width]
            arrival = recv[d, at:at + width]
            if bw.op == REDUCE:
                window.copy_(_acc(window, arrival))
            else:
                window.copy_(arrival)
    return state


def _run_waves(state, waves, fabric, rs_wire, ag_wire):
    """Execute bound striped waves on the ``(n, k, mrow)`` state."""
    for w, bw in enumerate(waves):
        op = "rs" if bw.op == REDUCE else "ag"
        with _scope(f"edst/t*/w{w}/{op}"):
            state = _run_wave(state, bw, fabric, rs_wire, ag_wire)
    return state


def _prep(x, spec, fabric, fractions):
    _check_fabric(x, spec, fabric)
    flat = x.reshape(spec.n, -1)
    bound = striped_tables(spec, flat.shape[1], _normalize(fractions))
    return flat, bound


def _cut_own(state, spec, bound):
    """Cut every vertex's own stripe out of each of its k rows (a single
    slot never wraps): ``(n, k, smax)``, zero past each stripe's width."""
    n = spec.n
    own = torch.zeros((n, spec.k, bound.smax), dtype=state.dtype,
                      device=state.device)
    for j in range(spec.k):
        for v in range(n):
            off, length = int(bound.own_off[j, v]), int(bound.own_len[j, v])
            own[v, j, :length] = state[v, j, off:off + length]
    return own


def tree_reduce_scatter(x, spec: StripedCollectiveSpec, fabric,
                        fractions=None, quantize: bool = False, codec=None):
    """Reduce-scatter over the stacked vertices of ``x`` (``(n, ...)``):
    returns the ``(n, k, smax)`` stack of every vertex's owner stripes,
    each row the globally-summed stripe of one tree's chunk, zero-padded
    to the widest stripe.  Stripe geometry (offset/width per tree) comes
    from :func:`stripe_layout`."""
    if spec.k == 0 or x.numel() == 0:
        return x
    flat, bound = _prep(x, spec, fabric, fractions)
    rs_wire, _ = _wires(quantize, codec, x.dtype, x.device)
    state = _rows_in(flat, bound.sizes, bound.mrow)
    state = _run_waves(state, bound.rs_waves, fabric, rs_wire, None)
    return _cut_own(state, spec, bound)


def stripe_slices(x, spec: StripedCollectiveSpec, fabric, fractions=None):
    """Every vertex's ``(k, smax)`` owner stripes of ``x`` (``(n, ...)``),
    stacked ``(n, k, smax)``: the same cut :func:`tree_reduce_scatter`
    applies after its reduce waves, with zero communication."""
    if spec.k == 0 or x.numel() == 0:
        return x
    flat, bound = _prep(x, spec, fabric, fractions)
    return _cut_own(_rows_in(flat, bound.sizes, bound.mrow), spec, bound)


def owner_stripes(vec, spec: StripedCollectiveSpec, fractions=None):
    """Every vertex's ``(k, smax)`` owner stripes of ONE replicated flat
    vector ``vec`` (``(P,)``), stacked ``(n, k, smax)``:
    :func:`stripe_slices` of ``vec`` expanded to n equal rows, cut
    straight from the one copy (stripe ``(v, j)`` starts at tree j's
    chunk offset plus ``own_off[j, v]``; past the chunk's true width it
    is zero) without building the ``(n, P)`` rows."""
    bound = striped_tables(spec, vec.numel(), _normalize(fractions))
    own = torch.zeros((spec.n, spec.k, bound.smax), dtype=vec.dtype,
                      device=vec.device)
    chunk = 0
    for j, s in enumerate(bound.sizes):
        for v in range(spec.n):
            off, length = int(bound.own_off[j, v]), int(bound.own_len[j, v])
            width = max(0, min(length, s - off))
            own[v, j, :width] = vec[chunk + off:chunk + off + width]
        chunk += s
    return own


def tree_allgather(owned, spec: StripedCollectiveSpec, fabric, shape,
                   fractions=None, quantize: bool = False, codec=None):
    """Allgather of owner stripes: the inverse of
    :func:`tree_reduce_scatter`.  ``owned`` is the ``(n, k, smax)`` stack
    of every vertex's stripes; returns ``(n, *shape)``, every row the full
    ``shape``-d array (every stripe of every tree)."""
    if spec.k == 0:
        return owned
    if owned.shape[0] != spec.n or fabric.n != spec.n:
        raise ValueError(f"spec for n={spec.n}, fabric n={fabric.n}, "
                         f"owned {tuple(owned.shape)}")
    size = 1
    for d in shape:
        size *= int(d)
    bound = striped_tables(spec, size, _normalize(fractions))
    _, ag_wire = _wires(quantize, codec, owned.dtype, owned.device)
    state = torch.zeros((spec.n, spec.k, bound.mrow), dtype=owned.dtype,
                        device=owned.device)
    for j in range(spec.k):
        for v in range(spec.n):
            off, length = int(bound.own_off[j, v]), int(bound.own_len[j, v])
            state[v, j, off:off + length] = owned[v, j, :length]
    state = _run_waves(state, bound.ag_waves, fabric, None, ag_wire)
    return _rows_out(list(state.unbind(1)), bound.sizes, size) \
        .reshape(spec.n, *shape)


def striped_allreduce(x, spec: StripedCollectiveSpec, fabric,
                      quantize: bool = False, fractions=None, codec=None):
    """Allreduce (sum) over the stacked vertices of ``x`` (``(n, ...)``) as
    reduce-scatter ∘ allgather on the COMPOSED wave program (one DAG: a
    shallow tree's gather overlaps a deep tree's scatter tail).  Returns
    ``(n, ...)`` with every row holding the sum."""
    if spec.k == 0 or x.numel() == 0:
        return x
    _check_fractions(spec, fractions)
    _note_trace("striped", spec, x,
                codec=(resolve_codec(codec, x.device) if quantize else None),
                fractions=fractions)
    shape, dtype = x.shape, x.dtype
    flat, bound = _prep(x, spec, fabric, fractions)
    rs_wire, ag_wire = _wires(quantize, codec, dtype, x.device)
    state = _rows_in(flat, bound.sizes, bound.mrow)
    state = _run_waves(state, bound.waves, fabric, rs_wire, ag_wire)
    return _rows_out(list(state.unbind(1)), bound.sizes, flat.shape[1]) \
        .reshape(shape).to(dtype)


def stripe_layout(spec: StripedCollectiveSpec, size: int, fractions=None):
    """The bound stripe geometry for a payload of ``size`` elements:
    the :class:`repro_torch.core.collectives.StripedTables` whose
    ``sizes`` / ``offsets`` / ``own_off`` / ``own_len`` describe exactly
    how :func:`tree_reduce_scatter` apportions ownership."""
    return striped_tables(spec, size, _normalize(fractions))


def rs_conservation_gap(flat_reduced, owned):
    """Integrity check for the scattered domain: after a reduce-scatter the
    owner stripes across the fabric partition the reduced vector, so the
    sum of every vertex's owned elements equals the sum of every vertex's
    (mean-contribution) payload.  Returns the RELATIVE gap
    ``|sum(owned) - sum(reduced)| / (|sum(reduced)| + 1)`` -- float
    reassociation noise when healthy, O(magnitude) when a wire corrupted,
    duplicated or dropped a stripe.  ``flat_reduced`` is ``(n, ...)``,
    every vertex's contribution ALREADY divided by the fabric size;
    ``owned`` the ``(n, k, smax)`` stripes.  The reference's two scalar
    ``psum``\\ s are the sums over the vertex dimension."""
    a = flat_reduced.to(torch.float32).sum()
    b = owned.to(torch.float32).sum()
    return (b - a).abs() / (a.abs() + 1.0)
