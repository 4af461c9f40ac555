"""Operations and bytes of the work a cell asks for, from the
configuration's sizes and from what the program does at run time.

* :func:`model_flops_per_token`: the model FLOPs of one training token,
  6 N + 12 L d T (PaLM, arXiv:2204.02311 app. B): N the matrix weights a
  token's forward touches (attention, the MLP or the k routed experts and
  the router, the tied unembedding over the real vocabulary), L layers,
  d the attention width (heads x head size) and T the sequence length.
  Recomputation is not counted.
* :func:`allreduce_least_seconds`: the least time of an allreduce, from
  its result alone: every local row read once and every local output row
  written once at HBM speed, and across cards 2 (W - 1) / W of one card's
  reduced payload over one NVLink direction; the larger binds.
* :class:`KernelBytes`: the bytes each launch of a kernel reads and
  writes, each input byte once and each output byte once, recorded from
  the program's own launches over one untimed call.
"""
from __future__ import annotations

from contextlib import contextmanager

import peaks


def model_flops_per_token(config: dict, seq: int) -> float:
    d = config["hidden_size"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // heads
    layers = config["num_hidden_layers"]
    attn = d * hd * (2 * heads + 2 * kv)
    if config.get("num_experts"):
        f = config["intermediate_size"]
        ffn = config["num_experts_per_tok"] * 3 * d * f \
            + d * config["num_experts"]
    else:
        ffn = 3 * d * config["intermediate_size"]
    n = layers * (attn + ffn) + config["vocab_size"] * d
    return 6.0 * n + 12.0 * layers * heads * hd * seq


def allreduce_least_seconds(rows: int, width: int, world: int,
                            itemsize: int = 4) -> tuple:
    """``(seconds, bound)`` of one allreduce of ``rows`` local rows of
    ``width`` elements on each of ``world`` cards."""
    hbm = peaks.hbm_seconds(2 * rows * width * itemsize)
    link = peaks.link_seconds(2 * (world - 1) / world * width * itemsize) \
        if world > 1 else 0.0
    return (link, "link") if link > hbm else (hbm, "hbm")


class KernelBytes:
    """Bytes read and written by a kernel wrapper's launches while
    :meth:`recording` runs: ``module.<name>`` is wrapped for the time,
    each call adding the bytes of its tensor arguments (read once) and of
    its tensor result (written once)."""

    def __init__(self):
        self.bytes = 0
        self.launches = 0

    @contextmanager
    def recording(self, module, name: str):
        import torch
        real = getattr(module, name)

        def nbytes(x):
            return x.numel() * x.element_size() \
                if isinstance(x, torch.Tensor) else 0

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            self.bytes += sum(nbytes(a) for a in args) \
                + sum(nbytes(a) for a in kw.values()) \
                + sum(nbytes(o) for o in outs)
            self.launches += 1
            return out

        setattr(module, name, wrapped)
        try:
            yield self
        finally:
            setattr(module, name, real)
