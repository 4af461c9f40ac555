"""The port's WKV6 recurrence against the reference.

The port's CPU path (the plain chunked version in ``ref.py``) is held
against the reference's Pallas kernel, called directly in interpret mode
(its ``ops`` dispatch to jnp off the TPU), against ``wkv6_chunked`` (the
model's chunked algorithm and the kernel's oracle) and against the exact
one-token ``wkv6_step`` loop, on the same numpy inputs, to 2e-4 as the
reference's own kernel test (``tests/test_kernels.py``).  The CUDA kernel
is held against the plain version on the card in
``test_torch_kernels_gpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.kernel import wkv6 as j_wkv6
from repro.models.rwkv6 import wkv6_chunked, wkv6_step
from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6 import ops as tops
from repro_torch.kernels.wkv6.ref import CLAMP, wkv6_ref

TOL = 2e-4
# the reference kernel test's shapes: (B, T, H, N, chunk)
SHAPES = [(2, 100, 3, 16, 32), (1, 64, 2, 64, 64), (2, 33, 4, 8, 16)]


def _inputs(b, t, h, n, seed, decay=(0.5, -4.0)):
    """r, k, v ~ N(0, 1); logw = -exp(a x + c), x ~ N(0, 1) (the reference
    test's decays by default); u ~ 0.5 N(0, 1); s0 ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(b, t, h, n).astype(np.float32) for _ in range(3))
    a, c = decay
    logw = -np.exp(a * rng.randn(b, t, h, n) + c).astype(np.float32)
    u = (0.5 * rng.randn(h, n)).astype(np.float32)
    s0 = rng.randn(b, h, n, n).astype(np.float32)
    return r, k, v, logw, u, s0


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, dtype=np.float32)
                               - np.asarray(b, dtype=np.float32))))


def _step_loop(r, k, v, logw, u, s):
    outs = []
    for i in range(r.shape[1]):
        o, s = wkv6_step(r[:, i], k[:, i], v[:, i], logw[:, i], u, s)
        outs.append(o)
    return jnp.stack(outs, 1), s


@pytest.mark.parametrize("b,t,h,n,c", SHAPES)
@pytest.mark.parametrize("oracle", ["interpret", "chunked", "step"])
def test_wkv_matches_reference(b, t, h, n, c, oracle):
    r, k, v, logw, u, _ = _inputs(b, t, h, n, b * t + n)
    out, s = tops.wkv(*_t(r, k, v, logw, u), chunk=c)
    assert out.shape == (b, t, h, n) and s.shape == (b, h, n, n)
    assert out.dtype == s.dtype == torch.float32
    jr, jk, jv, jw, ju = _j(r, k, v, logw, u)
    if oracle == "interpret":
        jo, js = j_wkv6(jr, jk, jv, jw, ju, chunk=c, interpret=True)
    elif oracle == "chunked":
        jo, js = wkv6_chunked(jr, jk, jv, jw, ju, chunk=c)
    else:
        jo, js = _step_loop(jr, jk, jv, jw, ju, jnp.zeros((b, h, n, n)))
    assert _err(out, jo) < TOL and _err(s, js) < TOL


@pytest.mark.parametrize("b,t,h,n,c", SHAPES)
def test_wkv_from_a_state_matches_reference(b, t, h, n, c):
    r, k, v, logw, u, s0 = _inputs(b, t, h, n, 7 + t)
    out, s = tops.wkv(*_t(r, k, v, logw, u), torch.from_numpy(s0), chunk=c)
    jo, js = wkv6_chunked(*_j(r, k, v, logw, u), s0=jnp.asarray(s0),
                          chunk=c)
    scale = max(1.0, float(np.max(np.abs(np.asarray(jo)))))
    assert _err(out, jo) < TOL * scale and _err(s, js) < TOL * scale
    lo, ls = _step_loop(*_j(r, k, v, logw, u), jnp.asarray(s0))
    assert _err(out, lo) < TOL * scale and _err(s, ls) < TOL * scale


def test_wkv_continues_from_its_final_state():
    """Two calls, the second started from the first's state, are one call
    (split at a chunk boundary, so the chunks are the same)."""
    r, k, v, logw, u, _ = _t(*_inputs(2, 96, 2, 16, 5))
    out, s = tops.wkv(r, k, v, logw, u, chunk=32)
    o1, s1 = tops.wkv(r[:, :64], k[:, :64], v[:, :64], logw[:, :64], u,
                      chunk=32)
    o2, s2 = tops.wkv(r[:, 64:], k[:, 64:], v[:, 64:], logw[:, 64:], u, s1,
                      chunk=32)
    assert torch.equal(torch.cat([o1, o2], 1), out) and torch.equal(s2, s)


def _chunk_range(logw, c):
    """The largest cumulative log-decay over the first chunk."""
    return float(-np.cumsum(logw[:, :c], axis=1).min())


def test_wkv_at_model_decays():
    """The model's decays, logw = -exp(-6 + small): the clamp stays inert
    and the port equals the reference."""
    b, t, h, n, c = 2, 150, 2, 32, 64
    r, k, v, logw, u, _ = _inputs(b, t, h, n, 11, (0.3, -6.0))
    assert _chunk_range(logw, c) < CLAMP
    out, s = tops.wkv(*_t(r, k, v, logw, u), chunk=c)
    jo, js = wkv6_chunked(*_j(r, k, v, logw, u), chunk=c)
    scale = max(1.0, float(np.max(np.abs(np.asarray(jo)))))
    assert _err(out, jo) < TOL * scale and _err(s, js) < TOL * scale


@pytest.fixture
def _flush_subnormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_wkv_in_the_clamp_regime(_flush_subnormals):
    """A strong decay whose cumulative log-decay over a chunk passes 85, so
    the clamp of both score factors acts.  There a clamped factor e^-85
    times an input below about 0.1 is subnormal.  XLA's CPU backend (like
    the TPU) flushes subnormals to zero; PyTorch (CPU and CUDA, and the
    CUDA kernel) keeps them, so the two platforms' answers differ there by
    up to about 1% of the largest output.  The port keeps subnormals and
    stays finite; with subnormals flushed, as the reference runs, it
    equals the reference's clamped algebra to the usual tolerance."""
    b, t, h, n, c = 2, 150, 2, 32, 64
    r, k, v, logw, u, _ = _inputs(b, t, h, n, 11, (0.5, 1.5))
    assert _chunk_range(logw, c) > CLAMP
    jo, js = wkv6_chunked(*_j(r, k, v, logw, u), chunk=c)
    scale = max(1.0, float(np.max(np.abs(np.asarray(jo)))))
    out, s = tops.wkv(*_t(r, k, v, logw, u), chunk=c)    # subnormals flushed
    assert _err(out, jo) < TOL * scale and _err(s, js) < TOL * scale
    torch.set_flush_denormal(False)
    out, s = tops.wkv(*_t(r, k, v, logw, u), chunk=c)
    assert bool(torch.isfinite(out).all() and torch.isfinite(s).all())
    assert _err(out, jo) < 0.02 * scale


def test_wkv_in_bf16_matches_reference():
    """bf16 r, k, v (f32 logw and u), as the model's prefill gives them:
    both sides compute in f32 and round the output once to bf16, so they
    agree to one bf16 rounding (plus the f32 tolerance, for outputs near
    zero); the f32 state to the f32 tolerance."""
    b, t, h, n, c = 2, 100, 3, 16, 32
    r, k, v, logw, u, _ = _inputs(b, t, h, n, 13)
    tr, tk, tv = (x.to(torch.bfloat16) for x in _t(r, k, v))
    out, s = tops.wkv(tr, tk, tv, *_t(logw, u), chunk=c)
    jr, jk, jv = (x.astype(jnp.bfloat16) for x in _j(r, k, v))
    jo, js = wkv6_chunked(jr, jk, jv, *_j(logw, u), chunk=c)
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=TOL)
    assert _err(s, js) < TOL


def test_short_sequence_matches_the_step_loop():
    """T < chunk: one chunk of T steps, as ``c = min(chunk, T)``."""
    r, k, v, logw, u, _ = _inputs(1, 20, 2, 16, 17)
    out, s = tops.wkv(*_t(r, k, v, logw, u), chunk=64)
    jo, js = _step_loop(*_j(r, k, v, logw, u), jnp.zeros((1, 2, 16, 16)))
    assert _err(out, jo) < TOL and _err(s, js) < TOL


def test_cpu_dispatch_takes_the_plain_version_and_builds_nothing():
    r, k, v, logw, u, s0 = _t(*_inputs(2, 9, 2, 4, 1))
    K.reset_launches()
    out, s = tops.wkv(r, k, v, logw, u, s0, chunk=4)
    ref = wkv6_ref(r, k, v, logw, u, s0, chunk=4)
    assert torch.equal(out, ref[0]) and torch.equal(s, ref[1])
    assert K.LAUNCHES["wkv6"] == 0 and K.LIB._lib is None


def test_other_devices_raise():
    x = torch.zeros((1, 2, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no WKV6 kernel"):
        tops.wkv(x, x, x, x, torch.zeros((1, 4), device="meta"))
    cpu = torch.zeros((1, 2, 1, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.wkv6(cpu, cpu, cpu, cpu, torch.zeros((1, 4)))
