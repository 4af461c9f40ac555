"""The plain reference of the allreduce cells: the vertices' rows summed
in f64, one row at a time, and the gap of an output against it.

``row_sum(..., dtype=torch.bfloat16)`` is the control: the same sum with
each row rounded to bfloat16 and added in bfloat16, the step below the
f32 the payload states.
"""
from __future__ import annotations

import torch


def row_sum(fill, n: int, width: int, dev, dtype=torch.float64):
    """The sum over vertices ``0..n-1`` of the rows ``fill(v, out)``
    writes into an f32 buffer, accumulated in ``dtype``."""
    buf = torch.empty(width, dtype=torch.float32, device=dev)
    acc = torch.zeros(width, dtype=dtype, device=dev)
    for v in range(n):
        fill(v, buf)
        acc += buf.to(dtype)
    return acc


def max_rel_err(rows, ref) -> float:
    """The widest gap of any element of any row of ``rows`` from ``ref``,
    over ``ref``'s largest magnitude."""
    ref64 = ref.to(torch.float64)
    scale = float(ref64.abs().max())
    worst = 0.0
    for row in rows:
        worst = max(worst, float((row.to(torch.float64) - ref64).abs().max()))
    return worst / scale
