"""Inputs made from ``--seed``: weights, token batches and payload rows.

Every draw comes from a generator on the device seeded by a 63-bit
mix of the run's seed and the draw's name, so the same seed gives the same
inputs and a seed of any size is taken.  The program and the plain
reference get the same tensors.

The weights follow the program's parameter layout (a tree of dicts, the
layers stacked on a leading dimension) and take their shapes from it; the
values are drawn here, in one call for the whole tree, and scaled by the
published initialisation conventions: norm scales one, the embedding and
the router N(0, 0.02), every other matrix N(0, 1 / fan-in).
"""
from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, *name) -> int:
    digest = hashlib.blake2b(repr((int(seed),) + name).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def generator(device, seed: int, *name) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *name))


def leaves(tree, prefix=()):
    """``[(path, leaf)]`` in sorted-key order at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def shapes_of(tree) -> list:
    """``[(path, shape)]`` of a tree of tensors."""
    return [(p, tuple(t.shape)) for p, t in leaves(tree)]


def init_scale(path: tuple, shape: tuple):
    """``"ones"``, or the standard deviation of the leaf at ``path``.  A
    leaf under ``layers`` has the layer count as its first dimension."""
    per = shape[1:] if path[0] == "layers" else shape
    last = path[-1]
    if last in ("scale", "q_norm", "k_norm"):
        return "ones"
    if path[0] == "embed" or last == "router":
        return 0.02
    if "attn" in path and last in ("wq", "wk", "wv"):
        return 1.0 / math.sqrt(per[0])                   # (d, heads, hd)
    if "attn" in path and last == "wo":
        return 1.0 / math.sqrt(per[0] * per[1])          # (heads, hd, d)
    if last in ("wi_gate", "wi_up", "wo") and len(per) >= 2:
        return 1.0 / math.sqrt(per[-2])                  # (..., in, out)
    raise ValueError(f"no initialisation rule for parameter {path}")


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(shapes: list, seed: int, device) -> dict:
    """The tree of f32 parameters of ``shapes`` (``[(path, shape)]``)
    drawn from ``seed``: one normal draw for the whole tree, each leaf
    then scaled or set to one, and copied out so that every leaf owns its
    storage."""
    sizes = [math.prod(s) for _, s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(device, seed,
                                                       "weights"),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for (path, shape), n in zip(shapes, sizes):
        leaf = flat[off:off + n].view(shape)
        off += n
        scale = init_scale(path, shape)
        if scale == "ones":
            leaf.fill_(1.0)
        else:
            leaf.mul_(scale)
        _put(out, path, leaf.clone())
    del flat
    return out


def tokens(seed: int, step: int, batch: int, seq: int, vocab: int,
           device) -> torch.Tensor:
    """Step ``step``'s batch: ``(batch, seq + 1)`` token ids, uniform over
    the vocabulary."""
    return torch.randint(0, vocab, (batch, seq + 1), device=device,
                         generator=generator(device, seed, "tokens", step))


def payload_row(seed: int, vertex: int, width: int, device,
                out=None) -> torch.Tensor:
    """Vertex ``vertex``'s f32 row of an allreduce payload, N(0, 1): the
    same row whichever rank holds the vertex."""
    if out is None:
        out = torch.empty(width, dtype=torch.float32, device=device)
    return out.normal_(generator=generator(device, seed, "row", vertex))
