"""k-tree allreduce on a fabric (the paper's Sec. 1.1 payoff, run):
the reference's ``repro.dist.tree_allreduce``, engine for engine.

Three executors share this module (a fourth, the striped reduce-scatter /
allgather engine, lives in :mod:`repro_torch.dist.striped`):

  * the **pipelined segmented** executor (:func:`pipelined_tree_allreduce`,
    the default engine) consumes a :class:`repro_torch.core.collectives.
    PipelinedAllreduceSpec`: the dependency-DAG list schedule packs every
    tree's messages, both phases, into the fewest ppermute-legal waves,
    and the payload streams down the trees in S segments so wave w moves
    segment ``t - w`` at step t (:func:`_scanned`).  ``segments="auto"``
    asks the device's calibrated :class:`CostModel` (:func:`auto_segments`);
  * the **fused global-round** executor (:func:`fused_tree_allreduce`)
    consumes a :class:`repro_torch.core.collectives.FusedAllreduceSpec`:
    round r of every tree merged into shared waves over k chunk rows.  The
    round-aligned baseline;
  * the **per-tree** executor (:func:`run_tree_program`, via a
    :class:`TreeAllreduceSpec`) runs each tree as its own serial chain of
    hops: the original baseline.

Where the reference runs inside ``shard_map`` on one vertex's ``(m,)``
chunk, here every tensor holds the fabric's local vertices as rows: all n
on a :class:`~repro_torch.dist.fabric.StackedFabric`, this rank's block on
a :class:`~repro_torch.dist.fabric.ProcessGroupFabric` (``fabric.rows``
of them).  So a per-vertex table becomes a column mask and a per-vertex
pack of one chunk becomes the row form of the codec over the vertex
rows, one scale per vertex; every row's arithmetic is its own, so a rank
computes the same bits for its rows as the stacked fabric does.  Every state a
kernel takes is a contiguous ``(n, m)`` block: k chunk rows (and, at S>1,
k x S segment blocks) are kept as separate tensors, never as strided views
of one buffer, and a hop that lands only in some rows accumulates row by
row under a column mask.  The kernels refuse non-contiguous input and the
engines never copy behind their back: :func:`_acc` views, it does not
reshape.

Every reduce hop accumulates through the tree-combine kernel (f32
accumulation), in every engine.  With ``quantize=True`` and codec
``"full"`` every reduce hop ships the int8 wire (lanes plus the f32 scale
in a 4-byte tail), and the broadcast phase packs each tree's total ONCE
and forwards the packed bytes verbatim down the trees.  Waves whose every
arrival adds into one row (``sole_add``, k=1 fabrics only) of the S=1
pipelined program decode and accumulate in one pass (``q8_combine``).

Every wave runs under a ``torch.profiler.record_function`` range named
``edst/t{tree}/w{wave}/{op}`` (``REPRO_WAVE_SCOPES=0`` or
:func:`set_wave_scopes` turn them off), so a torch profiler trace names
each wave, and each executor notes its program in the metrics registry
(:mod:`repro_torch.telemetry.metrics`).
"""
from __future__ import annotations

import os
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.collectives import (CostModel, FusedAllreduceSpec,
                                PipelinedAllreduceSpec,
                                StripedCollectiveSpec, chunk_sizes,
                                verify_compiled_spec, wave_wire_bytes)
from ..kernels.tree_combine.ops import (combine, q8_combine_rows,
                                        q8_pack_rows, q8_unpack_rows)
from ..telemetry import metrics as _metrics
from ..telemetry.spans import span
from . import fabric as fabric_mod


# ---------------------------------------------------------------------------
# static spec (per-tree baseline form)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TreeProgram:
    """One tree's rounds, each a tuple of (src, dst) pairs with unique
    sources and destinations (ppermute-legal).  ``bcast_dst[r][v]`` is the
    precompiled is-destination table of broadcast round r."""
    root: int
    reduce_rounds: tuple
    bcast_rounds: tuple
    bcast_dst: tuple = ()   # tuple[tuple[bool, ...]] aligned with bcast_rounds


@dataclass(frozen=True)
class TreeAllreduceSpec:
    n: int                 # fabric size = product of the reduced axis sizes
    axes: tuple            # mesh axis names the allreduce runs over
    trees: tuple           # tuple[TreeProgram]

    @property
    def k(self) -> int:
        return len(self.trees)

    @property
    def depth(self) -> int:
        return max((len(t.bcast_rounds) for t in self.trees), default=0)


def _split_unique(msgs):
    """Partition one round's (src, dst) messages into ppermute-legal
    sub-rounds: within a sub-round no vertex repeats as src or as dst."""
    out = []
    remaining = list(msgs)
    while remaining:
        srcs, dsts, taken, rest = set(), set(), [], []
        for s, d in remaining:
            if s in srcs or d in dsts:
                rest.append((s, d))
            else:
                srcs.add(s)
                dsts.add(d)
                taken.append((s, d))
        out.append(tuple(taken))
        remaining = rest
    return out


def _compile_rounds(rounds):
    out = []
    for msgs in rounds:
        out.extend(_split_unique(msgs))
    return tuple(out)


def _dst_tables(rounds, n: int):
    out = []
    for perm in rounds:
        table = [False] * n
        for _, d in perm:
            table[d] = True
        out.append(tuple(table))
    return tuple(out)


def spec_from_schedule(sched, axis_names, verify=None) -> TreeAllreduceSpec:
    """Compile an :class:`repro_torch.core.collectives.AllreduceSchedule`
    into a static per-tree spec bound to the given mesh axis names.  (The
    fused, pipelined and striped forms come from
    ``repro_torch.core.collectives``.)  Like those compilers, the fresh
    spec is statically verified per ``verify=``
    (``repro_torch.analysis.verify``; level resolved from
    ``REPRO_VERIFY_SPECS``) before being returned."""
    trees = []
    for ts in sched.trees:
        bcast = _compile_rounds(ts.bcast_rounds)
        trees.append(TreeProgram(root=ts.root,
                                 reduce_rounds=_compile_rounds(ts.reduce_rounds),
                                 bcast_rounds=bcast,
                                 bcast_dst=_dst_tables(bcast, sched.n)))
    spec = TreeAllreduceSpec(n=sched.n, axes=tuple(axis_names),
                             trees=tuple(trees))
    return verify_compiled_spec(spec, verify, "spec_from_schedule")


# ---------------------------------------------------------------------------
# wire codec and segment policies (shared by all executors)
# ---------------------------------------------------------------------------

_REDUCE_WIRE = {"full": "q8", "hybrid": "bf16", "bcast": None, "off": None}

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def resolve_codec(codec, device) -> str:
    """The quantized-wire policy for a payload on ``device`` (see the
    reference's ``resolve_codec``): ``"full"`` (int8 on every hop,
    pack-once broadcast), ``"hybrid"`` (bf16 reduce wires, int8
    broadcast), ``"bcast"`` (f32 reduce wires, int8 broadcast) or
    ``"off"``.  ``None``/``"auto"`` mirror the reference's backend split:
    ``"off"`` on a CPU device, ``"full"`` on CUDA.  ``device`` has no
    default: a caller that forgot it would get the CPU's ``"off"`` and an
    f32 program on the card where it asked for int8."""
    if codec in (None, "auto"):
        return "off" if torch.device(device).type == "cpu" else "full"
    if codec not in _REDUCE_WIRE:
        raise ValueError(f"codec {codec!r} not in "
                         "('auto', 'full', 'hybrid', 'bcast', 'off')")
    return codec


def auto_segments(spec: PipelinedAllreduceSpec, row_elems: int, device,
                  itemsize: int = 4) -> int:
    """The segment count ``segments="auto"`` picks for ``row_elems``-element
    chunk rows: the one :class:`CostModel` calibrated for ``device``'s type
    picks (``CostModel.for_backend``), as the reference asks its backend's.
    On a CPU device that is the reference's ``"cpu"`` row, on CUDA the
    port's measured ``"cuda"`` row.  Both set ``overlap=False`` (a step's
    waves run one after another), and that alone decides the pick: S
    segments then cost ``waves * steps * (alpha + m / (S * link_bw))``
    with ``steps >= S``, never less than S=1's ``waves * (alpha + m /
    link_bw)``, so the pick is 1 whatever the fitted alpha and link_bw
    are."""
    cm = CostModel.for_backend(torch.device(device).type)
    nbytes = row_elems * itemsize * max(1, spec.k)
    return max(1, min(cm.best_segments(nbytes, spec), row_elems or 1))


def resolve_segments(segments, spec, row_elems: int, device,
                     itemsize: int = 4) -> int:
    """The segment count for ``row_elems``-element chunk rows: ``"auto"``
    (or ``None``) asks :func:`auto_segments`; an explicit S >= 1 is capped
    at ``row_elems``, as in the reference."""
    if segments in (None, "auto"):
        return auto_segments(spec, row_elems, device, itemsize)
    s = int(segments)
    if s < 1:
        raise ValueError(f"segments must be >= 1, got {segments!r}")
    return max(1, min(s, row_elems))


# ---------------------------------------------------------------------------
# wave-level observability (shared by all executors)
# ---------------------------------------------------------------------------

_WAVE_SCOPES = os.environ.get("REPRO_WAVE_SCOPES", "1") != "0"


def set_wave_scopes(enabled: bool) -> bool:
    """Toggle the ``edst/t{j}/w{w}/{op}`` profiler ranges the executors
    open around every wave; returns the previous setting.  A range is
    opened only while a profiler runs: without one it would record
    nothing and still cost microseconds of host time a wave."""
    global _WAVE_SCOPES
    prev, _WAVE_SCOPES = _WAVE_SCOPES, bool(enabled)
    return prev


def _scope(label: str):
    """The wave's profiler range, or a null context when scopes are off
    or no profiler is running.  Like the reference's trace-time
    ``named_scope``, a range then costs nothing when nobody records: a
    ``record_function`` costs about 10 us of host time a wave, 7% of the
    striped 2x8 torus's host-bound 4 MiB allreduce on an H100."""
    if fabric_mod.recording():
        return fabric_mod.in_wave(label)
    return span(label) if _WAVE_SCOPES else nullcontext()


def _wave_label(w: int, wv) -> str:
    """``edst/t{tree}/w{wave}/{op}`` for a pipelined wave: the tree when
    the wave ships a single chunk row, ``t*`` for merged waves."""
    tree = f"t{wv.rows[0]}" if len(wv.rows) == 1 else "t*"
    red = bool(np.any(wv.reduce_flag))
    bc = bool(np.any(wv.bcast_flag))
    op = "mixed" if red and bc else ("reduce" if red else "bcast")
    return f"edst/{tree}/w{w}/{op}"


def _note_trace(engine: str, spec, x, codec=None, fractions=None) -> None:
    """Executor-entry metrics hook: notes the program (waves, static wire
    bytes of one vertex's payload, codec) the first time this process
    runs its signature, where the reference notes it when JAX traces it
    (see :func:`repro_torch.telemetry.metrics.note_program`)."""
    itemsize = x.element_size()
    wires = wave_wire_bytes(spec, x[0].numel() * itemsize, itemsize,
                            fractions)
    _metrics.note_program(engine, getattr(spec, "key", None) or spec,
                          waves=len(wires), wire_bytes=sum(wires),
                          codec=codec)


# ---------------------------------------------------------------------------
# hops
# ---------------------------------------------------------------------------

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


def _pack_rows32(rows):
    """Pack k chunk rows ``(n, m)`` ONCE, in one codec launch over all n*k
    (vertex, tree) rows (one scale each, as the reference's per-vertex
    ``(k, m)`` pack); returns k ``(n, L)`` int32 wires.  Clears ``rows``
    (the caller's list) so the f32 rows are freed before the waves."""
    n, k, m = rows[0].shape[0], len(rows), rows[0].shape[1]
    stacked = rows[0] if k == 1 else torch.stack(rows, 1).reshape(n * k, m)
    rows.clear()
    return list(_pack_wire32(stacked).reshape(n, k, -1).unbind(1))


def _unpack_rows32(packed, dtype, m):
    """Inverse of :func:`_pack_rows32`: one launch back to k ``(n, m)``
    rows."""
    n, k = packed[0].shape[0], len(packed)
    wires = torch.stack(packed, 1).reshape(n * k, -1)
    out = _unpack_wire32(wires, dtype, m).reshape(n, k, m)
    return list(out.unbind(1))


def _acc(partial, update):
    """Reduce accumulation: through the tree-combine (f32 accumulation)
    for float payloads, a plain add otherwise.  Both must be contiguous:
    ``view`` raises where ``reshape`` would copy."""
    if partial.dtype in _FLOATS:
        return combine(update.view(1, -1),
                       partial.view(-1)).view(partial.shape)
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


# ---------------------------------------------------------------------------
# per-tree execution -- the A/B baseline
# ---------------------------------------------------------------------------

def run_tree_program(c, tree: TreeProgram, fabric, quantize: bool = False,
                     codec=None, scope_tree: int = 0):
    """Reduce the stacked chunk ``c`` (``(n, m)``, row v held by vertex v)
    up ``tree`` and broadcast the total back down.

    The per-tree building block: tree j's whole chain completes before
    tree j+1 starts in program order.  ``codec`` is resolved for ``c``'s
    device.  ``scope_tree`` only names the profiler ranges
    (``edst/t{j}/...``)."""
    codec = resolve_codec(codec, c.device) if quantize else "off"
    wire = _REDUCE_WIRE[codec]
    # reduce: every non-root sends its accumulated value to its parent
    # exactly once, deepest level first, so parents accumulate complete
    # subtree sums before forwarding (non-receivers add the zeros the
    # fabric hands them)
    for w, perm in enumerate(tree.reduce_rounds):
        with _scope(f"edst/t{scope_tree}/w{w}/reduce"):
            c = _acc(c, _send(c, fabric, perm, wire))
    # broadcast: the root's total overwrites down the levels.  Quantized,
    # the total is packed ONCE and the int8 wire forwards verbatim.
    if not tree.bcast_rounds:
        return c
    base = len(tree.reduce_rounds)
    if codec != "off" and c.dtype in _FLOATS:
        packed = _pack_wire32(c)
        for w, (perm, table) in enumerate(zip(tree.bcast_rounds,
                                              tree.bcast_dst)):
            with _scope(f"edst/t{scope_tree}/w{base + w}/bcast"):
                recv = fabric.ppermute(packed, perm)
                packed = torch.where(fabric.column(table), recv, packed)
        return _unpack_wire32(packed, c.dtype, c.shape[1])
    for w, (perm, table) in enumerate(zip(tree.bcast_rounds,
                                          tree.bcast_dst)):
        with _scope(f"edst/t{scope_tree}/w{base + w}/bcast"):
            recv = fabric.ppermute(c, perm)
            c = torch.where(fabric.column(table), recv, c)
    return c


def per_tree_allreduce(x, spec: TreeAllreduceSpec, fabric,
                       quantize: bool = False):
    """Allreduce (sum) over the fabric's vertices of ``x`` (``(rows, ...)``,
    the local ones), one serial chain of hops per tree (the pre-fusion
    executor).  As in the
    reference, the codec is the device's default (``resolve_codec(None,
    device)``: int8 on CUDA, off on the CPU)."""
    if spec.k == 0 or x.numel() == 0:
        return x
    _check_fabric(x, spec, fabric)
    _note_trace("per_tree", spec, x,
                codec=resolve_codec(None, x.device) if quantize else None)
    n, shape, dtype, k = fabric.rows, x.shape, x.dtype, spec.k
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    pad = (-size) % k
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.view(n, k, -1)
    # one contiguous (n, m) copy of tree j's chunk at a time (k=1: flat
    # itself; no engine writes into its input)
    outs = [run_tree_program(chunks[:, j].contiguous(), tree, fabric,
                             quantize, scope_tree=j)
            for j, tree in enumerate(spec.trees)]
    out = torch.cat(outs, 1) if k > 1 else outs[0]
    if pad:
        out = out[:, :size]
    return out.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# shared row helpers
# ---------------------------------------------------------------------------

def _check_fabric(x, spec, fabric):
    if fabric.n != spec.n or x.shape[0] != fabric.rows:
        raise ValueError(f"spec for n={spec.n}, fabric n={fabric.n} with "
                         f"{fabric.rows} local rows, payload "
                         f"{tuple(x.shape)}")


def _check_fractions(spec, fractions):
    if fractions is not None and len(fractions) != spec.k:
        raise ValueError(f"{len(fractions)} fractions for k={spec.k} trees; "
                         "spec and striping must come from the same schedule")


def _row_sizes(size: int, k: int, fractions):
    """(per-tree chunk widths, common row width): uniform ``ceil(size/k)``
    rows, or ``chunk_sizes`` widths padded to the widest."""
    if fractions is None:
        mrow = -(-size // k)
        return (mrow,) * k, mrow
    sizes = chunk_sizes(size, fractions)
    return sizes, max(sizes)


def _segments_of(flat, sizes, segments, msub):
    """The S>1 state: ``segs[j][s]`` is tree j's segment s for every vertex,
    its own contiguous ``(n, msub)`` tensor (zero past the row's data), so
    each hop's kernels take it as it is and a landed segment replaces its
    entry without a copy."""
    size = flat.shape[1]
    segs, off = [], 0
    for s_j in sizes:
        have = max(0, min(s_j, size - off))   # the last row may run short
        row = []
        for s in range(segments):
            lo = s * msub
            width = max(0, min(msub, have - lo))
            c = flat[:, off + lo:off + lo + width]
            row.append(c.contiguous() if width == msub
                       else F.pad(c, (0, msub - width)))
        segs.append(row)
        off += s_j
    return segs


def _segments_out(segs, sizes, size, dtype):
    """Reassemble ``(n, size)`` from the segments, freeing each as it is
    copied out."""
    n, msub = segs[0][0].shape
    out = torch.empty((n, size), dtype=dtype, device=segs[0][0].device)
    off = 0
    for j, s_j in enumerate(sizes):
        have = max(0, min(s_j, size - off))
        for s in range(len(segs[j])):
            lo = s * msub
            width = max(0, min(msub, have - lo))
            if width:
                out[:, off + lo:off + lo + width] = segs[j][s][:, :width]
            segs[j][s] = None
        off += s_j
    return out


def _rows_of(flat, sizes, mrow):
    """The k chunk rows, each a contiguous ``(n, mrow)`` tensor:
    :func:`_segments_of` at one segment."""
    return [row[0] for row in _segments_of(flat, sizes, 1, mrow)]


def _rows_out(rows, sizes, size):
    """Inverse of :func:`_rows_of`: each row cut back to its stripe."""
    return _segments_out([[r] for r in rows], sizes, size, rows[0].dtype)


def _select_payload(rows, send_rows, send_row, fabric):
    """The wave's outgoing chunk: most waves ship one row (``send_rows``,
    the distinct senders' rows); multi-row waves select per vertex via
    the spec's send-row table ``send_row``."""
    payload = rows[send_rows[0]]
    for r in send_rows[1:]:
        payload = torch.where(fabric.column(send_row == r), rows[r],
                              payload)
    return payload


# ---------------------------------------------------------------------------
# fused global-round execution -- the round-aligned baseline
# ---------------------------------------------------------------------------

def _wave_rows(rnd):
    """Static (senders' rows, receivers' rows) of one wave."""
    srcs = np.array([s for s, _ in rnd.perm], np.int64)
    dsts = np.array([d for _, d in rnd.perm], np.int64)
    return (tuple(int(r) for r in np.unique(rnd.send_row[srcs])),
            tuple(int(r) for r in np.unique(rnd.recv_row[dsts])))


def _fused_send(rows, rnd, fabric, wire=None):
    """One wave: every vertex ships the chunk row its table says, one
    ppermute moves all trees' round-r traffic at once; returns the arrival
    and the rows it lands in."""
    send_rows, recv_rows = _wave_rows(rnd)
    payload = _select_payload(rows, send_rows, rnd.send_row, fabric)
    return _send(payload, fabric, rnd.perm, wire), recv_rows


def fused_tree_allreduce(x, spec: FusedAllreduceSpec, fabric,
                         quantize: bool = False, fractions=None, codec=None):
    """Allreduce (sum) over the stacked vertices of ``x`` (``(n, ...)``)
    with the fused global-round program.

    Each row is flattened and striped into k chunk rows (uniform, or
    ``chunk_sizes(size, fractions)`` when weighted striping is requested),
    padded to a common width.  A wave whose arrivals land in one row adds
    (or overwrites) that row alone; a multi-row wave lands row by row
    under the column mask ``recv_row == j & recv_flag``, where the
    reference adds a ``(k, m)`` one-hot contribution (the same sums: the
    rows it leaves out gain exact zeros there).  Returns ``(n, ...)`` with
    every row holding the sum."""
    if spec.k == 0 or x.numel() == 0:
        return x
    _check_fabric(x, spec, fabric)
    _check_fractions(spec, fractions)
    codec = resolve_codec(codec, x.device) if quantize else "off"
    _note_trace("fused", spec, x, codec=codec if quantize else None,
                fractions=fractions)
    r_wire = _REDUCE_WIRE[codec]
    n, shape, dtype, k = fabric.rows, x.shape, x.dtype, spec.k
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    sizes, m = _row_sizes(size, k, fractions)
    rows = _rows_of(flat, sizes, m)

    # reduce: arrivals accumulate into their tree's row; non-receivers
    # hold the zeros the fabric hands them
    for w, rnd in enumerate(spec.reduce_rounds):
        with _scope(f"edst/t*/w{w}/reduce"):
            recv, recv_rows = _fused_send(rows, rnd, fabric, r_wire)
            if len(recv_rows) == 1:
                rows[recv_rows[0]] = _acc(rows[recv_rows[0]], recv)
                continue
            for j in recv_rows:
                sel = fabric.column((rnd.recv_row == j) & rnd.recv_flag)
                rows[j] = _acc(rows[j], torch.where(sel, recv, 0))

    # broadcast: arrivals overwrite their tree's row on destinations.
    # Quantized, the per-row totals are packed ONCE into the int32-lane
    # wire and forwarded verbatim down the levels.
    q_bcast = codec != "off" and bool(spec.bcast_rounds) and dtype in _FLOATS
    if q_bcast:
        rows = _pack_rows32(rows)
    base = len(spec.reduce_rounds)
    for w, rnd in enumerate(spec.bcast_rounds):
        with _scope(f"edst/t*/w{base + w}/bcast"):
            recv, recv_rows = _fused_send(rows, rnd, fabric)
            for j in recv_rows:
                sel = rnd.recv_flag if len(recv_rows) == 1 \
                    else (rnd.recv_row == j) & rnd.recv_flag
                rows[j] = torch.where(fabric.column(sel), recv, rows[j])
    if q_bcast:
        rows = _unpack_rows32(rows, dtype, m)

    out = _rows_out(rows, sizes, size)
    return out.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# pipelined segmented execution -- the default engine
# ---------------------------------------------------------------------------

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


def pipelined_tree_allreduce(x, spec: PipelinedAllreduceSpec, fabric,
                             quantize: bool = False, segments="auto",
                             fractions=None, codec=None):
    """Allreduce (sum) over the stacked vertices of ``x`` (``(n, ...)``,
    row v held by vertex v) with the pipelined wave program.

    Each row is flattened and striped into k chunk rows (uniform, or
    weighted by ``fractions`` via ``chunk_sizes``), padded to a common
    width.  ``segments`` splits each row into S pipeline segments: S=1
    runs the wave list directly; S>1 streams the segments through the
    waves (:func:`_scanned`).  ``"auto"`` asks :func:`auto_segments`.
    Returns ``(n, ...)`` with every row holding the sum.
    ``quantize``/``codec`` select the int8 wire (see the module
    docstring)."""
    if spec.k == 0 or x.numel() == 0:
        return x
    _check_fabric(x, spec, fabric)
    _check_fractions(spec, fractions)
    codec = resolve_codec(codec, x.device) if quantize else "off"
    if x.dtype not in _FLOATS:
        codec = "off"       # integer payloads always travel verbatim
    quantize = codec != "off"   # model-disabled codec: the f32 program
    n, shape, dtype = fabric.rows, x.shape, x.dtype
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    sizes, mrow = _row_sizes(size, spec.k, fractions)
    segments = resolve_segments(segments, spec, mrow, x.device,
                                x.element_size())
    msub = -(-mrow // segments)
    _note_trace("pipelined", spec, x, codec=codec if quantize else None,
                fractions=fractions)

    if segments > 1:
        segs = _segments_of(flat, sizes, segments, msub)
        segs = _scanned(segs, spec, fabric, codec if quantize else None,
                        dtype)
        return _segments_out(segs, sizes, size, dtype).reshape(shape)

    rows = _rows_of(flat, sizes, mrow)
    if quantize:
        rows = _q8_unrolled(rows, spec, fabric, codec)
    else:
        for w, wv in enumerate(spec.waves):
            with _scope(_wave_label(w, wv)):
                payload = _select_payload(rows, wv.rows, wv.send_row, fabric)
                recv = fabric.ppermute(payload, wv.perm)
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
    for w, wv in enumerate(spec.q8_waves[:bnd]):
        with _scope(_wave_label(w, wv)):
            payload = _select_payload(rows, wv.rows, wv.send_row, fabric)
            if r_wire == "q8" and payload.dtype in _FLOATS:
                wire = fabric.ppermute(q8_pack_rows(payload), wv.perm)
                if wv.sole_add >= 0:
                    rows[wv.sole_add] = q8_combine_rows(wire,
                                                        rows[wv.sole_add])
                    continue
                recv = q8_unpack_rows(wire, dtype)
            else:
                recv = _send(payload, fabric, wv.perm, r_wire)
            rows = _apply_wave(rows, wv, recv, fabric)
    if bnd == len(spec.q8_waves) or dtype not in _FLOATS:
        for w, wv in enumerate(spec.q8_waves[bnd:]):
            with _scope(_wave_label(bnd + w, wv)):
                payload = _select_payload(rows, wv.rows, wv.send_row, fabric)
                recv = fabric.ppermute(payload, wv.perm)
                rows = _apply_wave(rows, wv, recv, fabric)
        return rows
    mrow = rows[0].shape[1]
    packed = _pack_rows32(rows)     # pack-once, one launch over n*k rows
    for w, wv in enumerate(spec.q8_waves[bnd:]):
        with _scope(_wave_label(bnd + w, wv)):
            payload = _select_payload(packed, wv.rows, wv.send_row, fabric)
            recv = fabric.ppermute(payload, wv.perm)
            for j in range(len(packed)):
                if wv.bcast_flag[j].any():
                    packed[j] = torch.where(fabric.column(wv.bcast_flag[j]),
                                            recv, packed[j])
    return _unpack_rows32(packed, dtype, mrow)


def _scanned(segs, spec, fabric, codec, dtype):
    """S>1: software-pipeline the wave program over the step index.  At
    step t wave w moves segment ``t - stage(w)``; a pair whose segment is
    out of range is a fill/drain no-op, which the reference issues masked
    and this loop skips (t is known on the host), so every wave moves
    each segment once and the bytes moved are the S=1 program's.  Each
    segment meets the same adds in the same order as at S=1, so an f32
    result equals the S=1 result.

    Quantized (``codec`` not None), a pack pseudo-stage at the phase
    boundary packs each segment of every tree ONCE (one scale per vertex
    per segment), shifting the broadcast waves one step later; the
    packed segments forward verbatim and decode at the end."""
    k, nseg = len(segs), len(segs[0])
    waves = spec.waves if codec is None else spec.q8_waves
    boundary = len(waves) if codec is None else spec.q8_boundary
    stage = [w if (codec is None or w < boundary) else w + 1
             for w in range(len(waves))]
    nsteps = (len(waves) if codec is None else len(waves) + 1) + nseg - 1
    r_wire = None if codec is None else _REDUCE_WIRE[codec]
    packed = [[None] * nseg for _ in range(k)] if codec is not None \
        else None
    for t in range(nsteps):
        for w, wv in enumerate(waves):
            seg = t - stage[w]
            if not 0 <= seg < nseg:
                continue
            bcast_wave = codec is not None and w >= boundary
            state = packed if bcast_wave else segs
            with _scope(_wave_label(w, wv)):
                cur = [state[j][seg] for j in range(k)]
                payload = _select_payload(cur, wv.rows, wv.send_row, fabric)
                recv = _send(payload, fabric, wv.perm,
                             None if bcast_wave else r_wire)
                new = _apply_wave(cur, wv, recv, fabric)
                for j in range(k):
                    state[j][seg] = new[j]
        seg = t - boundary
        if codec is not None and 0 <= seg < nseg:
            # pack pseudo-stage: segment t - boundary crosses into bcast
            for j in range(k):
                packed[j][seg] = q8_pack_rows(segs[j][seg])
                segs[j][seg] = None
    if codec is not None:
        segs = [[q8_unpack_rows(p, dtype) for p in row] for row in packed]
    return segs


def tree_allreduce(x, spec, fabric, quantize: bool = False,
                   segments="auto"):
    """Allreduce (sum) over the stacked vertices of ``x`` (``(n, ...)``).

    Dispatches on the spec form: a
    :class:`repro_torch.core.collectives.PipelinedAllreduceSpec` runs the
    pipelined segmented engine (the default the rest of the port
    compiles), a :class:`repro_torch.core.collectives.StripedCollectiveSpec`
    the striped reduce-scatter/allgather engine
    (:mod:`repro_torch.dist.striped`; stripe windows replace segment
    streaming, so ``segments`` does not apply), a
    :class:`repro_torch.core.collectives.FusedAllreduceSpec` the fused
    global-round baseline, a :class:`TreeAllreduceSpec` the per-tree
    chains.  All return ``(n, ...)`` with every row holding the sum.
    """
    if isinstance(spec, PipelinedAllreduceSpec):
        return pipelined_tree_allreduce(x, spec, fabric, quantize, segments)
    if isinstance(spec, StripedCollectiveSpec):
        from .striped import striped_allreduce  # late: striped imports us
        return striped_allreduce(x, spec, fabric, quantize=quantize)
    if isinstance(spec, FusedAllreduceSpec):
        return fused_tree_allreduce(x, spec, fabric, quantize)
    return per_tree_allreduce(x, spec, fabric, quantize)
