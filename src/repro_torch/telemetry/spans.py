"""Named host ranges around the program's layers, for a ``torch.profiler``
trace.

:func:`span` opens a ``torch.profiler.record_function`` range only while a
profiler records; otherwise it returns one shared null context, so a span
costs a single flag check and allocates nothing.  The ranges land in the
profiler's Kineto trace beside the device's kernels, copies and fills, on
the same clock, so a trace reader can place device work by the range its
launch falls in.

The spans the port opens (besides the engines' ``edst/t*/w*/op`` waves,
:func:`repro_torch.dist.tree_allreduce._scope`):

  * ``step/forward/v{v}``, ``step/backward/v{v}``, ``step/rows/v{v}``
    (:func:`repro_torch.dist.steps.make_train_step`'s per-vertex loop):
    vertex ``v``'s forward, its backward, and the copy of its gradient
    into row ``v`` of the ``(rows, P)`` buffer, once a microbatch;
  * ``step/sync`` (the gradient sync: the allreduce, or ZeRO-1's
    reduce-scatter and allgather) and ``step/optim`` (AdamW with its
    clip);
  * ``fabric/zero``, ``fabric/gather``, ``fabric/p2p``
    (:meth:`repro_torch.dist.fabric._BlockFabric.ppermute`): the output's
    zero fill, the local rows' gather, and the sends and receives of the
    pairs that cross ranks.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch

_OFF = nullcontext()


def span(name: str, vertex: int | None = None):
    """The range ``name`` (``name`` followed by ``vertex`` when one is
    given) while a profiler records, else a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(
            name if vertex is None else f"{name}{vertex}")
    return _OFF
