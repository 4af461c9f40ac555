"""The port's RG-LRU scan against the reference.

The port's CPU path (the plain sequential loop in ``ref.py``) is held
against the reference's Pallas kernel, called directly in interpret mode
(its ``ops`` dispatch to jnp off the TPU), and against its oracle
``rglru_ref`` (the model's associative scan), on the same numpy inputs,
to 1e-4 as the reference's own kernel test.  The CUDA kernel is held
against the plain version on the card in ``test_torch_kernels_gpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.kernel import rglru_scan as j_rglru_scan
from repro.kernels.rglru.ref import rglru_ref as j_rglru_ref
from repro_torch.kernels.rglru import kernel as K
from repro_torch.kernels.rglru import ops as tops
from repro_torch.kernels.rglru.ref import rglru_ref

TOL = 1e-4


def _inputs(b, t, w, seed):
    rng = np.random.RandomState(seed)
    a = (1.0 / (1.0 + np.exp(-rng.randn(b, t, w)))).astype(np.float32)
    bx = rng.randn(b, t, w).astype(np.float32)
    h0 = rng.randn(b, w).astype(np.float32)
    return a, bx, h0


@pytest.mark.parametrize("b,t,w,c,wt", [(2, 100, 48, 32, 16),
                                        (1, 64, 128, 64, 128),
                                        (3, 17, 8, 8, 8)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_matches_reference(b, t, w, c, wt, with_h0):
    a, bx, h0 = _inputs(b, t, w, b * t + w)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    h, h_last = tops.lru_scan(torch.from_numpy(a), torch.from_numpy(bx), th0)
    assert h.shape == (b, t, w) and h_last.shape == (b, w)
    assert h.dtype == h_last.dtype == torch.float32
    refs = (j_rglru_scan(jnp.asarray(a), jnp.asarray(bx), jh0, chunk=c,
                         width_tile=wt, interpret=True),
            j_rglru_ref(jnp.asarray(a), jnp.asarray(bx), jh0))
    for jh, jl in refs:
        assert np.max(np.abs(h.numpy() - np.asarray(jh))) < TOL
        assert np.max(np.abs(h_last.numpy() - np.asarray(jl))) < TOL


def test_scan_at_model_gate_values():
    """The model's decays: a = exp(-8 softplus(lam) r) spans (0, 1), and
    the recurrence carries h over 300 steps without drifting."""
    rng = np.random.RandomState(7)
    lam = np.linspace(0.9, 4.0, 64).astype(np.float32)
    r = 1.0 / (1.0 + np.exp(-rng.randn(2, 300, 64)))
    a = np.exp(-8.0 * np.log1p(np.exp(lam)) * r).astype(np.float32)
    bx = (np.sqrt(1 - a ** 2) * rng.randn(2, 300, 64)).astype(np.float32)
    h, h_last = rglru_ref(torch.from_numpy(a), torch.from_numpy(bx))
    jh = j_rglru_ref(jnp.asarray(a), jnp.asarray(bx))[0]
    assert np.max(np.abs(h.numpy() - np.asarray(jh))) < TOL
    assert torch.equal(h_last, h[:, -1])


def test_sequential_loop_is_one_step_per_position():
    """h_t = a_t * h_{t-1} + b_t exactly, step by step, from h0."""
    a, bx, h0 = (torch.from_numpy(x) for x in _inputs(2, 5, 3, 0))
    h, _ = rglru_ref(a, bx, h0)
    prev = h0
    for t in range(5):
        assert torch.equal(h[:, t], a[:, t] * prev + bx[:, t])
        prev = h[:, t]


def test_scan_continues_from_h_last():
    """Two scans, the second started from the first's h_last, are one scan
    (the loop is the same, step for step) and match the reference's."""
    a, bx, h0 = _inputs(2, 30, 16, 3)
    ta, tb, th0 = (torch.from_numpy(x) for x in (a, bx, h0))
    h1, l1 = tops.lru_scan(ta[:, :11], tb[:, :11], th0)
    h2, l2 = tops.lru_scan(ta[:, 11:], tb[:, 11:], l1)
    h, h_last = tops.lru_scan(ta, tb, th0)
    assert torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(l2, h_last)
    jh, jl = j_rglru_ref(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    assert np.max(np.abs(h.numpy() - np.asarray(jh))) < TOL
    assert np.max(np.abs(h_last.numpy() - np.asarray(jl))) < TOL


def test_cpu_dispatch_takes_the_plain_version_and_builds_nothing():
    a, bx, h0 = (torch.from_numpy(x) for x in _inputs(2, 9, 4, 1))
    K.reset_launches()
    h, h_last = tops.lru_scan(a, bx, h0)
    ref = rglru_ref(a, bx, h0)
    assert torch.equal(h, ref[0]) and torch.equal(h_last, ref[1])
    assert K.LAUNCHES["rglru_scan"] == 0 and K.LIB._lib is None


def test_other_devices_raise():
    a = torch.zeros((1, 2, 3), device="meta")
    with pytest.raises(ValueError, match="no RG-LRU scan kernel"):
        tops.lru_scan(a, a)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.rglru_scan(torch.zeros((1, 2, 3)), torch.zeros((1, 2, 3)))
