"""The flash attention backward's arithmetic on the CPU.

``ref.py::attention_bwd_ref`` is FlashAttention-2's backward as the CUDA
kernel computes it (p recomputed from the forward's row log-sum-exp,
D = rowsum(dO o O), dS = p o (dP - D)), in f32.  It is held against
``torch.autograd`` of the plain forward ``attention_ref`` and against
``jax.grad`` of the reference's blockwise ``repro/models/layers.py::sdpa``
on the same numpy inputs: causal, a sliding window and a full mask, G = 1
and G = 3, S not a multiple of the kernel's 64-key tiles.  The CUDA
kernels are held against ``attention_bwd_ref`` on the card in
``test_torch_flash_bwd_gpu``.  The routing rule of ``layers.attention``
(which cache-free inputs take the kernels) is checked here on its inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                      attention_ref,
                                                      attention_ref_lse)
from repro_torch.models import layers as L

CASES = [
    # b, s, h, kv, d, causal, window
    (2, 70, 4, 4, 32, True, None),        # G = 1, S = 64 + 6
    (1, 100, 9, 3, 64, True, None),       # smollm-135m's layout, ragged
    (2, 130, 6, 2, 32, True, 48),         # G = 3, a window over tile edges
    (1, 96, 3, 3, 64, False, None),       # G = 1, full mask
    (1, 77, 6, 2, 32, False, None),       # G = 3, full mask, ragged
]
# f32 sums in another order, over at most a few hundred terms of O(1)
TOL = 2e-5


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, n, d).astype(np.float32)
            for n in (h, kv, kv, h)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", CASES)
def test_lse_is_the_rows_logsumexp(b, s, h, kv, d, causal, window):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(b, s, h, kv, d, s))
    out, lse = attention_ref_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(out, attention_ref(q, k, v, causal=causal,
                                          window=window))
    assert lse.shape == (b, kv, s, h // kv) and lse.dtype == torch.float32
    # head kv * G + g, query i: log sum_j exp(q_i . k_j / sqrt(d)) over the
    # keys it sees
    g = h // kv
    for kvh, gg, i in ((0, 0, 0), (kv - 1, g - 1, s - 1), (0, g - 1, s // 2)):
        sc = (k[0, :, kvh] @ q[0, i, kvh * g + gg]) / np.sqrt(d)
        j = torch.arange(s)
        seen = (j <= i if causal else torch.ones(s, dtype=torch.bool))
        if window is not None:
            seen &= j > i - window
        want = torch.logsumexp(sc[seen].double(), 0)
        assert abs(float(lse[0, kvh, i, gg]) - float(want)) < 1e-5


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", CASES)
def test_bwd_ref_matches_autograd(b, s, h, kv, d, causal, window):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, s, h, kv, d,
                                                          s + h))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, window=window)
    out.backward(do)
    _, lse = attention_ref_lse(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, out.detach(), do, lse, causal=causal,
                            window=window)
    for x, g in zip(leaves, got):
        assert g.dtype == torch.float32 and g.shape == x.shape
        assert _rel(g, x.grad) < TOL


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", CASES)
def test_bwd_ref_matches_jax_grad_of_sdpa(b, s, h, kv, d, causal, window):
    """The reference's blockwise sdpa (32-row and 32-key blocks, so the
    online softmax and its checkpointed steps run) under ``jax.grad``."""
    q, k, v, do = _inputs(b, s, h, kv, d, s + 2 * h)
    cfg = jl.AttnCfg(d_model=h * d, n_heads=h, n_kv=kv, head_dim=d,
                     window=window)
    pos = jnp.arange(s)

    def loss(q_, k_, v_):
        out = jl.sdpa(q_, k_, v_, pos, pos, cfg,
                      "causal" if causal else "full", q_block=32,
                      kv_block=32)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                              for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = attention_ref_lse(tq, tk, tv, causal=causal, window=window)
    got = attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal=causal,
                            window=window)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) < TOL


def test_cpu_dispatch_differentiates_the_plain_version():
    """On the CPU ``ops.attention`` is the plain version under autograd:
    its gradients are the backward's formulas."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 40, 6, 2, 32, 3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tops.attention(*leaves, window=16)
    out.backward(do)
    _, lse = attention_ref_lse(q, k, v, window=16)
    for x, g in zip(leaves, attention_bwd_ref(q, k, v, out.detach(), do,
                                              lse, window=16)):
        assert _rel(g, x.grad) < TOL


@pytest.mark.parametrize("dtype,d,mask,t,takes", [
    (torch.bfloat16, 64, "causal", 2048, True),     # smollm-135m training
    (torch.bfloat16, 128, "causal", 4096, True),    # olmoe-1b-7b training
    (torch.bfloat16, 32, "causal", 77, True),
    (torch.bfloat16, 64, "full", 1536, True),       # aligned to 512
    (torch.bfloat16, 64, "full", 600, False),       # not aligned
    (torch.bfloat16, 256, "causal", 2048, False),   # no backward instance
    (torch.float32, 64, "causal", 2048, False),     # the backward is bf16
])
def test_layers_route_by_input(dtype, d, mask, t, takes):
    q = torch.empty((1, t, 3, d), dtype=dtype, device="meta")
    k = torch.empty((1, t, 1, d), dtype=dtype, device="meta")
    assert L._flash_trains(q, k, mask) is takes


def test_cpu_training_attention_stays_on_sdpa_and_counts_nothing():
    """On the CPU a cache-free layer call is the blockwise sdpa (what the
    reference-parity tests hold), and the card's counter stays still."""
    cfg = L.AttnCfg(d_model=64, n_heads=4, n_kv=2, head_dim=16)
    p = L.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(24)
    before = dict(FK.LAUNCHES)
    leaves = {n: w.clone().requires_grad_(True) for n, w in p.items()}
    out, _ = L.attention(leaves, cfg, x, pos, q_block=8, kv_block=8)
    out.sum().backward()
    assert FK.LAUNCHES == before
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    want = L.sdpa(L.rope(q, pos), L.rope(k, pos), v, pos, pos,
                  cfg, q_block=8, kv_block=8)
    want = torch.einsum("bshk,hkd->bsd", want, p["wo"])
    assert torch.equal(out.detach(), want.detach())
