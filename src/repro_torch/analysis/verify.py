"""The part of the reference's static verifier (``repro/analysis/verify.py``)
that the fault loop needs: the ``sid-out-of-range`` check every schedule
id passes through, and the engine name of a compiled spec.

The static verifier itself (per-wave ppermute legality, link exclusivity,
routing-table coherence, tree recovery, the stripe-window checks) is not
ported yet; the port's tests hold its specs equal, table for table, to
the reference's, which that verifier proves.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.collectives import (FusedAllreduceSpec, PipelinedAllreduceSpec,
                                StripedCollectiveSpec)


@dataclass(frozen=True)
class Violation:
    code: str
    detail: str

    def __str__(self):
        return f"[{self.code}] {self.detail}"


def check_schedule_id(num_entries: int, schedule_id: int) -> Violation | None:
    """The ``sid-out-of-range`` check.  The port runs a failure class by
    indexing a table of prebuilt callables, and a Python index wraps a
    negative id (``entries[-1]`` is the last class), so an id outside
    ``[0, num_entries)`` would run the WRONG failure-class program
    without a word.  Every caller that selects an entry by id gates it
    through this check."""
    if 0 <= schedule_id < num_entries:
        return None
    return Violation(
        "sid-out-of-range",
        f"schedule id {schedule_id} outside the precompiled entry table "
        f"[0, {num_entries}); lax.switch would clamp it to branch "
        f"{min(max(schedule_id, 0), num_entries - 1)}")


def engine_of(spec) -> str:
    """Engine name of a compiled spec.  The per-tree form lives in
    ``repro_torch.dist.tree_allreduce``, so it is duck-typed on its
    attributes instead of imported here."""
    if isinstance(spec, PipelinedAllreduceSpec):
        return "pipelined"
    if isinstance(spec, FusedAllreduceSpec):
        return "fused"
    if isinstance(spec, StripedCollectiveSpec):
        return "striped"
    if (hasattr(spec, "trees") and hasattr(spec, "axes")
            and hasattr(spec, "n")
            and all(hasattr(t, "reduce_rounds") for t in spec.trees)):
        return "per_tree"
    raise TypeError(f"not a compiled allreduce spec: {type(spec).__name__}")
