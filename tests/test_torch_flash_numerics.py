"""The roundings of the bf16 flash attention kernel, measured on the CPU.

The CUDA kernel for bf16 inputs (``flash_attention.cu``,
``flash_fwd_bf16_kernel``) computes the scores from bf16 q and K in f32
on the tensor cores, runs the online softmax over 64-key tiles in f32 and
in base 2 (scores scaled by log2(e) / sqrt(D), ``exp2``), rounds p to bf16 before ``p @ v`` (the one rounding the plain version
does not make) and rounds the output to bf16.  :func:`kernel_emulation`
below repeats that arithmetic in plain PyTorch, and is held against the
reference's oracle ``attention_ref`` and its Pallas kernel in interpret
mode, on the same numpy inputs, to the reference's bf16 tolerance 2e-2,
and against ``attention_ref`` element by element to the bound the card
tests hold the kernel to (``ref.py::bf16_kernel_bound``):
the five cases of the reference's kernel test, and recurrentgemma-2b's
layout (10 query heads over one key head of 256) with windows that cross
64-key tile edges and S not a multiple of 64.

The emulation visits every 64-key tile from key 0 for every row, where
the kernel visits only the tiles some row of its block can see.  The two
agree: a tile before a row's first live key is wiped by the rescale
``exp2(-1e30 - m) = 0`` once a live key arrives, and a tile after its last
live key adds ``p = exp2(-1e30 - m) = 0`` with a rescale of 1.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                      bf16_kernel_bound)

TILE = 64          # the kernel's keys per tile
NEG = -1e30        # the kernel's (and the reference's) masked score
TOL = 2e-2         # the reference's bf16 tolerance

CASES = [
    # b, s, h, kv, d, qb, kb, causal, window (the reference's test cases)
    (2, 128, 8, 2, 64, 32, 64, True, None),
    (1, 100, 4, 4, 32, 32, 32, True, None),
    (2, 256, 8, 1, 128, 64, 128, True, 48),
    (1, 128, 2, 2, 64, 128, 128, False, None),
    (1, 64, 4, 2, 128, 16, 16, True, None),
    # recurrentgemma-2b's layout: windows across tile edges, ragged S
    (1, 200, 10, 1, 256, 64, 64, True, 70),
    (1, 161, 10, 1, 256, 32, 64, True, 65),
    (1, 97, 10, 1, 256, 32, 32, True, 1),
]


def kernel_emulation(q, k, v, *, causal=True, window=None, round_p=True):
    """q: (B, S, H, D), k, v: (B, T, KV, D) bf16 -> (B, S, H, D) bf16, by
    the bf16 kernel's arithmetic: f32 scores of bf16 operands scaled by the
    f32 product of 1 / sqrt(D) and log2(e), the online (m, l) softmax in
    base 2 over 64-key tiles in f32 with -1e30 masks, l summed
    from the f32 p, p rounded to bf16 for ``p @ v`` (f32 accumulation;
    ``round_p=False`` keeps it f32), the output ``acc * (1 / max(l,
    1e-30))`` rounded to bf16."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.float().reshape(b, s, kv, g, d)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, kv, g, s), NEG)
    l = torch.zeros((b, kv, g, s))
    acc = torch.zeros((b, kv, g, s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, t, TILE):
        k1 = min(t, k0 + TILE)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kf[:, k0:k1]) * scale
        kpos = torch.arange(k0, k1)[None, :]
        live = torch.ones((s, k1 - k0), dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        sc = torch.where(live, sc, torch.tensor(NEG))
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.bfloat16().float() if round_p else p,
            vf[:, k0:k1])
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).bfloat16()


def _qkv(b, s, h, kv, d, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, n, d).astype(np.float32) for n in (h, kv, kv)]
    return ([jnp.asarray(x).astype(jnp.bfloat16) for x in arrays],
            [torch.from_numpy(x).bfloat16() for x in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("b,s,h,kv,d,qb,kb,causal,window", CASES)
def test_bf16_kernel_roundings_fit_the_reference_tolerance(
        b, s, h, kv, d, qb, kb, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, h, kv, d, s + h + d)
    out = kernel_emulation(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h, d)
    errs = [float(np.max(np.abs(_np(out) - _np(ref)))) for ref in (
        j_ref(jq, jk, jv, causal=causal, window=window),
        j_flash(jq, jk, jv, causal=causal, window=window, q_block=qb,
                kv_block=kb, interpret=True))]
    # the per-element bound the card holds the kernel to
    ref = attention_ref(tq, tk, tv, causal=causal, window=window)
    ratio = float(((out.float() - ref.float()).abs() / bf16_kernel_bound(
        tq, tk, tv, ref, causal=causal, window=window)).max())
    print(f"bf16 kernel emulation vs attention_ref / Pallas interpret: "
          f"max|diff| {errs[0]!r} / {errs[1]!r} (limit {TOL}); "
          f"largest share of the per-element bound {ratio!r}")
    assert max(errs) < TOL
    assert ratio <= 1.0


def test_emulation_without_the_p_rounding_is_the_plain_version():
    """With p left in f32, the tiled online softmax is the plain
    version's one-block softmax up to f32 reordering, so the outputs
    differ by at most one bf16 rounding: what the rounding of p adds is
    all the emulation measures beyond the plain version."""
    _, (tq, tk, tv) = _qkv(1, 150, 10, 1, 64, 3)
    exact = kernel_emulation(tq, tk, tv, window=70, round_p=False).float()
    plain = attention_ref(tq, tk, tv, window=70).float()
    assert bool(((exact - plain).abs()
                 <= 2.0 ** -7 * plain.abs() + 1e-6).all())
    rounded = kernel_emulation(tq, tk, tv, window=70).float()
    assert 0.0 < float((rounded - exact).abs().max()) < TOL
