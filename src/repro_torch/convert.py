"""Parameter trees between the reference and the port.

The port's parameters are nested dicts of tensors with the reference's
keys, shapes and dtypes, so ``np.asarray`` of every leaf of the
reference's ``init_lm`` params feeds both packages: the tests start both
from the same numbers this way.  The functions here take and give numpy
arrays only; neither package is imported.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """A nested dict of array-likes (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_jax(tree):
    """Inverse of :func:`params_from_jax`: a tree of numpy arrays (which
    ``jax.numpy.asarray`` takes leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
