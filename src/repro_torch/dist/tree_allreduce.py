"""The pipelined EDST allreduce on a stacked fabric (the paper's Sec. 1.1
payoff, run): the reference's ``repro.dist.tree_allreduce`` default
engine at one segment, line for line.

The executor consumes a :class:`repro_torch.core.collectives.
PipelinedAllreduceSpec`: the dependency-DAG list schedule packs every
tree's messages, both phases, into the fewest ppermute-legal waves.  Where
the reference runs inside ``shard_map`` on one vertex's ``(m,)`` chunk,
here every tensor holds all n vertices as rows (:class:`StackedFabric`),
so a per-vertex table becomes a column mask and a per-vertex pack of one
chunk becomes the row form of the codec over n vertex rows, one scale per
vertex.

Every reduce hop accumulates through the tree-combine kernel (f32
accumulation); with ``quantize=True`` and codec ``"full"`` every reduce
hop ships the int8 wire (lanes plus the f32 scale in a 4-byte tail), and
the broadcast phase packs each tree's total ONCE (rows over n*k) and
forwards the packed bytes verbatim down the trees.  Waves whose every
arrival adds into one row (``sole_add``, k=1 fabrics only) decode and
accumulate in one pass (``q8_combine``).

Only ``segments=1`` exists in this package: the S>1 segment-streaming scan
and the fused and per-tree baselines of the reference are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.collectives import PipelinedAllreduceSpec, chunk_sizes
from ..kernels.tree_combine.ops import (combine, q8_combine_rows,
                                        q8_pack_rows, q8_unpack_rows)

_REDUCE_WIRE = {"full": "q8", "hybrid": "bf16", "bcast": None, "off": None}

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def resolve_codec(codec=None, device="cpu") -> str:
    """The quantized-wire policy (see the reference's ``resolve_codec``):
    ``"full"`` (int8 on every hop, pack-once broadcast), ``"hybrid"``
    (bf16 reduce wires, int8 broadcast), ``"bcast"`` (f32 reduce wires,
    int8 broadcast) or ``"off"``.  ``"auto"`` mirrors the reference's
    backend split: ``"off"`` on a CPU device, ``"full"`` on CUDA."""
    if codec in (None, "auto"):
        return "off" if torch.device(device).type == "cpu" else "full"
    if codec not in _REDUCE_WIRE:
        raise ValueError(f"codec {codec!r} not in "
                         "('auto', 'full', 'hybrid', 'bcast', 'off')")
    return codec


def resolve_segments(segments="auto") -> int:
    """The segment count.  ``"auto"`` is 1: the reference asks a cost
    model calibrated per backend, and there is no CUDA calibration yet
    (unknown backends fall back to TPU link constants), so no S>1 choice
    could be justified on this card.  S>1 is not ported."""
    if segments in (None, "auto"):
        return 1
    s = int(segments)
    if s < 1:
        raise ValueError(f"segments must be >= 1, got {segments!r}")
    if s > 1:
        raise NotImplementedError("segments > 1 (the pipelined scan) is not "
                                  "ported yet")
    return 1


def _pack_wire32(x):
    """Quantize rows into a 32-bit-lane wire: ``(R, m) float -> (R,
    ceil(m/4) + 1) int32`` holding the int8 payload four to a lane plus
    the scale lane.  The broadcast phase forwards this form (4x fewer
    elements per gather and mask); int32 lanes copy bits exactly, and
    zero-filled arrivals decode to exact zeros (zero scale)."""
    pad = -x.shape[-1] % 4
    if pad:
        x = F.pad(x, (0, pad))
    return q8_pack_rows(x.contiguous()).view(torch.int32)


def _unpack_wire32(w32, dtype, m):
    """Inverse of :func:`_pack_wire32` back to ``(R, m)`` rows."""
    w8 = w32.contiguous().view(torch.int8)
    return q8_unpack_rows(w8, dtype)[:, :m]


def _acc(partial, update):
    """Reduce accumulation: through the tree-combine (f32 accumulation)
    for float payloads, a plain add otherwise."""
    if partial.dtype in _FLOATS:
        return combine(update.reshape(1, -1),
                       partial.reshape(-1)).reshape(partial.shape)
    return partial + update


def _send(x, fabric, perm, wire=None):
    """ppermute a stacked chunk; vertices nobody sends to receive zeros.
    ``wire`` compresses the hop: ``"q8"`` ships int8 with the f32 scale in
    its tail, ``"bf16"`` casts on and off the wire.  Integer payloads
    always travel verbatim."""
    if wire is not None and x.dtype not in _FLOATS:
        wire = None
    if wire == "q8":
        return q8_unpack_rows(fabric.ppermute(q8_pack_rows(x), perm),
                              x.dtype)
    if wire == "bf16":
        return fabric.ppermute(x.to(torch.bfloat16), perm).to(x.dtype)
    return fabric.ppermute(x, perm)


def _select_payload(rows, wv, fabric):
    """The wave's outgoing chunk: most waves ship one row; multi-row waves
    select per vertex via the spec's send-row table."""
    payload = rows[wv.rows[0]]
    for r in wv.rows[1:]:
        payload = torch.where(fabric.column(wv.send_row == r), rows[r],
                              payload)
    return payload


def _apply_wave(rows, wv, recv, fabric):
    """Land one wave's arrival: accumulate into reduce destinations,
    overwrite broadcast destinations, leave everyone else untouched.
    ``wv.sole_add`` waves skip masking (zero payload on non-destinations)."""
    for j in range(len(rows)):
        rf, bf = wv.reduce_flag[j], wv.bcast_flag[j]
        if not (rf.any() or bf.any()):
            continue
        if wv.sole_add == j:
            rows[j] = _acc(rows[j], recv)
            continue
        base = rows[j]
        if rf.any():
            base = _acc(base, torch.where(fabric.column(rf), recv, 0))
        if bf.any():
            base = torch.where(fabric.column(bf), recv, base)
        rows[j] = base
    return rows


def _rows_of(flat, sizes, mrow):
    rows, off = [], 0
    for s in sizes:
        c = flat[:, off:off + s]   # the last row may run short of its size
        off += s
        rows.append(c.contiguous() if c.shape[1] == mrow
                    else F.pad(c, (0, mrow - c.shape[1])))
    return rows


def _rows_out(rows, sizes, size):
    """Cut each row back to its stripe and reassemble ``(n, size)``."""
    parts = [rows[j][:, :s] for j, s in enumerate(sizes) if s > 0]
    out = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
    return out[:, :size]


def pipelined_tree_allreduce(x, spec: PipelinedAllreduceSpec, fabric,
                             quantize: bool = False, segments="auto",
                             fractions=None, codec=None):
    """Allreduce (sum) over the stacked vertices of ``x`` (``(n, ...)``,
    row v held by vertex v) with the pipelined wave program.

    Each row is flattened and striped into k chunk rows (uniform, or
    weighted by ``fractions`` via ``chunk_sizes``), padded to a common
    width.  Returns ``(n, ...)`` with every row holding the sum.
    ``quantize``/``codec`` select the int8 wire (see the module
    docstring); ``segments`` must resolve to 1."""
    if spec.k == 0 or x.numel() == 0:
        return x
    if x.shape[0] != spec.n or fabric.n != spec.n:
        raise ValueError(f"spec for n={spec.n}, fabric n={fabric.n}, "
                         f"payload {tuple(x.shape)}")
    if fractions is not None and len(fractions) != spec.k:
        raise ValueError(f"{len(fractions)} fractions for k={spec.k} trees; "
                         "spec and striping must come from the same schedule")
    resolve_segments(segments)
    codec = resolve_codec(codec, x.device) if quantize else "off"
    if x.dtype not in _FLOATS:
        codec = "off"       # integer payloads always travel verbatim
    n, shape, dtype = spec.n, x.shape, x.dtype
    flat = x.reshape(n, -1)
    size, k = flat.shape[1], spec.k
    if fractions is None:
        mrow = -(-size // k)
        sizes = (mrow,) * k
    else:
        sizes = chunk_sizes(size, fractions)
        mrow = max(sizes)
    rows = _rows_of(flat, sizes, mrow)

    if codec != "off":
        rows = _q8_unrolled(rows, spec, fabric, codec)
    else:
        for wv in spec.waves:
            recv = fabric.ppermute(_select_payload(rows, wv, fabric), wv.perm)
            rows = _apply_wave(rows, wv, recv, fabric)

    out = _rows_out(rows, sizes, size)
    return out.reshape(shape).to(dtype)


def _q8_unrolled(rows, spec, fabric, codec):
    """S=1 quantized program: phase-separated waves; reduce hops' wire per
    the codec policy, then every row packs ONCE at the reduce/broadcast
    boundary and the int8 wire forwards verbatim down the trees."""
    dtype = rows[0].dtype
    r_wire = _REDUCE_WIRE[codec]
    bnd = spec.q8_boundary
    for wv in spec.q8_waves[:bnd]:
        payload = _select_payload(rows, wv, fabric)
        if r_wire == "q8" and payload.dtype in _FLOATS:
            wire = fabric.ppermute(q8_pack_rows(payload), wv.perm)
            if wv.sole_add >= 0:
                rows[wv.sole_add] = q8_combine_rows(wire, rows[wv.sole_add])
                continue
            recv = q8_unpack_rows(wire, dtype)
        else:
            recv = _send(payload, fabric, wv.perm, r_wire)
        rows = _apply_wave(rows, wv, recv, fabric)
    if bnd == len(spec.q8_waves) or dtype not in _FLOATS:
        for wv in spec.q8_waves[bnd:]:
            recv = fabric.ppermute(_select_payload(rows, wv, fabric), wv.perm)
            rows = _apply_wave(rows, wv, recv, fabric)
        return rows
    n, k, mrow = spec.n, len(rows), rows[0].shape[1]
    # pack-once: one codec launch over all n*k (vertex, tree) rows
    stacked = torch.stack(rows, 1).reshape(n * k, mrow)
    packed = list(_pack_wire32(stacked).reshape(n, k, -1).unbind(1))
    del stacked
    rows.clear()    # the caller's list: free the f32 rows before the waves
    for wv in spec.q8_waves[bnd:]:
        recv = fabric.ppermute(_select_payload(packed, wv, fabric), wv.perm)
        for j in range(k):
            if wv.bcast_flag[j].any():
                packed[j] = torch.where(fabric.column(wv.bcast_flag[j]),
                                        recv, packed[j])
    wires = torch.stack(packed, 1).reshape(n * k, -1)
    out = _unpack_wire32(wires, dtype, mrow).reshape(n, k, mrow)
    return list(out.unbind(1))
