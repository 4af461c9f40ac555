"""Per-device static analysis of a torch program (the counterpart of the
reference's ``repro/analysis/hlo.py``, which parses XLA's optimized HLO).

There is no HLO here: the program is the sequence of aten ops a call
issues, recorded by a ``TorchDispatchMode``.  :func:`analyze_program`
runs a callable under the recorder and aggregates, per device,

  * dot FLOPs (``2 * prod(output dims) * contraction``) of every
    ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``,
  * bytes touched (operand + output bytes of every op that is not a
    view),
  * collective bytes and counts by the reference's five kinds: torch's
    functional and c10d collectives (``all_gather_into_tensor`` ->
    ``all-gather``, ``reduce_scatter_tensor`` -> ``reduce-scatter``,
    ``all_reduce`` -> ``all-reduce``, ``all_to_all_single`` ->
    ``all-to-all``) and the fabric's ``ppermute``
    (:meth:`repro_torch.dist.fabric.StackedFabric.ppermute`) ->
    ``collective-permute``, each counted at its output bytes, as the
    reference's dry run reckons them.

Eager loops run in full, so a layer loop's trip count multiplies into the
totals by itself.  The counts are **local**: an op on DTensors is not
counted at its global shapes; the recorder lets DTensor run and counts
the local ops it issues on each device's shards, and the collectives its
redistributions issue.  ``bytes_touched`` counts every eager op's
operands and output: eager code does not fuse, so it reads well above an
XLA compile's count of the same step and is not comparable to the
reference's.

The contract side (:class:`HloContract`, :func:`collective_sites`,
:func:`lint_hlo`) reads a recording of the fabric's ``ppermute`` calls
(:func:`repro_torch.dist.fabric.record_wires`): per call its wave, its
dtype and its wire elements.  A site is one wave of the program: S
segments issue S calls of a wave, one site, so the reference's "one
collective per wave, flat in the segment count" is ``sites ==
ppermutes`` for every S.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional (returning their output) and c10d (in place, output first)
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _dot_flops(name: str, args, out) -> float:
    """2 * prod(out dims) * contraction of a matrix product."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _empty(kinds=COLLECTIVES) -> dict:
    return {c: 0 for c in kinds}


@dataclass
class HloStats:
    dot_flops: float
    bytes_touched: float
    collective_bytes: dict
    collective_counts: dict

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class ProgramRecorder(TorchDispatchMode):
    """Counts every aten op of the calls made under it, per device (see
    the module docstring); :attr:`stats` holds the totals.

    It also keeps the live bytes of one device: every storage an op
    creates counts from its first output until Python drops its last
    reference, on top of the storages :meth:`hold` names (the program's
    arguments); :attr:`peak_bytes` is the most that were live at once.
    On fake tensors (the dry run: pass their ``fake_mode``) this is the
    device's peak without an allocator's rounding or a caching
    allocator's slack.  Ops on fake tensors of any other mode are not
    counted: DTensor's sharding propagation runs each new op once on fake
    tensors of the global shapes, which no device runs."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode   # the program's own fake tensors'
        self.stats = HloStats(0.0, 0.0, _empty(), _empty())
        self._wires = None
        self._seen = weakref.WeakSet()
        self.live_bytes = self.peak_bytes = 0

    def hold(self, tensors) -> int:
        """Count the storages of ``tensors`` (local ones: pass a
        DTensor's ``to_local()``) as live; returns the bytes added."""
        added = 0
        for t in tensors:
            added += self._track(t)
        return added

    def _track(self, t) -> int:
        if t.device.type == "meta":      # shapes only: no memory anywhere
            return 0
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen.add(st)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)
        return n

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __enter__(self):
        from ..dist.fabric import record_wires
        self._wires = record_wires()
        self._wire_log = self._wires.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._wires.__exit__(*exc)
        st = self.stats
        for call in self._wire_log:
            st.collective_counts["collective-permute"] += 1
            st.collective_bytes["collective-permute"] += call.nbytes
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run: its local ops and collectives come back
            # here on the shards
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) and a.fake_mode is not
               self.fake_mode for a in _tensors([args, out])):
            # DTensor's sharding propagation running an op on fake
            # tensors of the global shapes: no device runs it
            return out
        name = func.__name__.split(".")[0]
        if name == "wait_tensor" or func.is_view:
            return out
        for t in _tensors(out):
            self._track(t)
        st = self.stats
        kind = _COLLECTIVE_KIND.get(name)
        if kind is not None:
            nbytes = _nbytes(out if func.namespace == "_c10d_functional"
                             else args[0])
            st.collective_bytes[kind] += nbytes
            st.collective_counts[kind] += 1
        elif name in _DOTS and func.namespace == "aten":
            st.dot_flops += _dot_flops(name, args, out)
        st.bytes_touched += _nbytes(list(args) + list(kwargs.values())) \
            + _nbytes(out)
        return out


def analyze_program(fn, *args, **kwargs) -> HloStats:
    """The per-device :class:`HloStats` of ``fn(*args, **kwargs)``."""
    with ProgramRecorder() as rec:
        fn(*args, **kwargs)
    return rec.stats


# ---------------------------------------------------------------------------
# contract linter (flat site counting)
# ---------------------------------------------------------------------------
#
# ``analyze_program`` counts every call -- the right thing for cost
# accounting.  The contract linter counts sites instead: one a wave of
# the program, however many segments stream through it.


@dataclass(frozen=True)
class CollectiveSite:
    """One ``collective-permute`` site: a wave of the program (counted
    once, not once a segment).  ``dtype`` / ``elems`` are one vertex's
    wire (the reference's site output shape), the largest of the wave's
    calls."""
    kind: str
    dtype: str
    elems: int


@dataclass(frozen=True)
class HloContract:
    """What a correct executor run must look like, enforced by
    :func:`lint_hlo`.  ``None`` fields are unconstrained.

    ``ppermutes``           exact ``collective-permute`` site count
                            (== the spec's wave count: one collective per
                            wave, flat in the segment count);
    ``max_f32_sites``       most f32-wire ppermute sites allowed (the
                            quantized broadcast waves: reduce wires must
                            be int8);
    ``max_f32_wire_elems``  largest f32 wire element count allowed (the
                            bit-packed lane width: a full f32 row means
                            the codec was silently dropped).
    """
    ppermutes: int | None = None
    max_f32_sites: int | None = None
    max_f32_wire_elems: int | None = None


_DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int8: "s8", torch.uint8: "u8",
               torch.int32: "s32", torch.float64: "f64"}


def collective_sites(calls) -> list:
    """Every ``collective-permute`` site of a recording
    (:func:`repro_torch.dist.fabric.record_wires`'s list): the calls of
    one wave are one site; a call outside any wave is a site of its
    own."""
    sites: dict = {}
    for i, c in enumerate(calls):
        key = c.wave if c.wave is not None else ("call", i)
        dt = _DTYPE_NAME.get(c.dtype, str(c.dtype))
        prev = sites.get(key)
        if prev is None or c.elems > prev.elems:
            sites[key] = CollectiveSite("collective-permute", dt, c.elems)
    return list(sites.values())


def lint_hlo(calls, contract: HloContract) -> list:
    """Check a recording of ppermute calls against an
    :class:`HloContract`; returns a list of human-readable violation
    strings (empty = clean).  Use
    :func:`repro_torch.analysis.verify.hlo_contract_for` to derive the
    contract from a compiled spec."""
    perms = collective_sites(calls)
    out = []
    if contract.ppermutes is not None and len(perms) != contract.ppermutes:
        out.append(
            f"collective-permute site count {len(perms)} != contracted "
            f"{contract.ppermutes} (one collective per wave, flat in the "
            "segment count)")
    f32 = [s for s in perms if s.dtype == "f32"]
    if contract.max_f32_sites is not None \
            and len(f32) > contract.max_f32_sites:
        out.append(
            f"{len(f32)} f32-wire collective-permute sites, contract "
            f"allows {contract.max_f32_sites} (reduce wires must be "
            "quantized)")
    if contract.max_f32_wire_elems is not None:
        for s in f32:
            if s.elems > contract.max_f32_wire_elems:
                out.append(
                    f"f32 wire of {s.elems} elements exceeds the packed-"
                    f"lane cap {contract.max_f32_wire_elems} (an "
                    "unquantized full row leaked onto the wire)")
    return out
