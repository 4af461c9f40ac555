"""AdamW with cosine schedule and global-norm clipping (the reference's
``repro/optim/adamw.py``: the same constants, f32 moments, no decay for
parameters with ``ndim < 2``, and the learning rate taken at ``step + 1``).

Parameters, gradients and moments are nested dicts of tensors; leaves are
visited in sorted-key order, the reference's tree-flatten order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


class OptState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order at every level (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` then cosine decay to 0, in f32."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm_clip(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@dataclass(frozen=True)
class AdamW:
    lr_fn: object
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> OptState:
        # zeros_like: a DTensor parameter's moments keep its placements
        zeros = lambda p: tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), p)
        return OptState(0, zeros(params), zeros(params))

    @torch.no_grad()
    def apply(self, params, grads, state: OptState):
        """One update; returns ``(params, state, {"grad_norm", "lr"})``."""
        grads, gnorm = global_norm_clip(grads, self.clip_norm)
        step = state.step + 1
        lr = self.lr_fn(step)
        b1, b2 = self.b1, self.b2
        t = torch.tensor(float(step), dtype=torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t

        def upd(p, g, m, v):
            dev = p.device
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            mhat = m / c1.to(dev)
            vhat = v / c2.to(dev)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            p32 = p.float()
            decay = self.weight_decay if p.dim() >= 2 else 0.0
            p32 = p32 - lr.to(dev) * (delta + decay * p32)
            return p32.to(p.dtype), m, v

        out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads,
                       state.mu, state.nu)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return (pick(0), OptState(step, pick(1), pick(2)),
                {"grad_norm": gnorm, "lr": lr})
