"""The port's rwkv6 serving path against the reference, on the CPU in f32.

Both start from the reference's key-0 parameters (carried over by
``repro_torch.convert``) and the same numpy prompts.  Reduced rwkv6-7b (2
layers, d 128, 4 heads of 32) with a 100-token prompt, so the WKV runs two
chunks of 64 with a ragged tail: prefill logits and every cache entry
against ``repro.models.rwkv6.prefill``, eight greedy decode steps against
``decode_step``, and the logits at every position against ``forward``.

Tolerances: 1e-4 for logits and caches (both sides compute in f32 with the
same chunked algebra; only the order of sums differs); greedy tokens
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rwkv6 as jW
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import rwkv6 as tW

ARCH = "rwkv6-7b"
PROMPT, STEPS, BATCH = 100, 8, 2
TOL = 1e-4
CACHE_KEYS = ("state", "last_tm", "last_cm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol=TOL):
    return float(np.max(np.abs(_np(a) - _np(b)))) < tol


@pytest.fixture(scope="module")
def rw():
    jcfg = jconfigs.get(ARCH).reduced()
    tcfg = tconfigs.get(ARCH).reduced()
    jparams, _ = jW.init_rwkv6_model(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = np.random.RandomState(5).randint(0, jcfg.vocab,
                                               (BATCH, PROMPT))
    jlog, jcache = jW.prefill(jcfg, jparams, jnp.asarray(prompts))
    jdec = jax.jit(lambda c, t: jW.decode_step(jcfg, jparams, c, t))
    with torch.inference_mode():
        tlog, tcache = tW.prefill(tcfg, tparams, torch.from_numpy(prompts))
        pre = (jlog, tlog, jax.tree.map(np.asarray, jcache),
               {k: v.clone() for k, v in tcache.items()})
        steps = []
        for _ in range(STEPS):
            jtok = jnp.argmax(jlog[..., :jcfg.vocab], axis=-1)[:, None]
            ttok = tlog[..., :tcfg.vocab].argmax(-1)[:, None]
            steps.append((jlog, tlog, np.asarray(jtok), ttok.numpy()))
            jlog, jcache = jdec(jcache, jtok)
            tlog, tcache = tW.decode_step(tcfg, tparams, tcache, ttok)
        steps.append((jlog, tlog, None, None))
    return jcfg, tcfg, jparams, tparams, prompts, pre, steps, jcache, tcache


def test_reduced_rwkv6_config_matches_reference():
    j, t = jconfigs.get(ARCH), tconfigs.get(ARCH)
    assert j.param_count() == t.param_count()
    j, t = j.reduced(), t.reduced()
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv",
              "head_size", "d_ff", "vocab", "vocab_padded",
              "act_dtype_name", "remat"):
        assert getattr(j, f) == getattr(t, f), f
    assert j.param_count() == t.param_count()
    assert t.d_model // t.head_size == t.n_heads      # u fits the heads


def test_rwkv6_prefill_logits_match_reference(rw):
    *_, pre, _, _, _ = rw
    jlog, tlog, _, _ = pre
    assert tlog.shape == jlog.shape and _close(jlog, tlog)


@pytest.mark.parametrize("key", CACHE_KEYS)
def test_rwkv6_prefill_cache_matches_reference(rw, key):
    *_, pre, _, _, _ = rw
    jc, tc = pre[2][key], pre[3][key]
    assert tuple(tc.shape) == jc.shape
    assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
    assert _close(jc, tc)


def test_rwkv6_decode_matches_reference(rw):
    *_, steps, jend, tend = rw
    for jlog, tlog, jtok, ttok in steps:
        assert _close(jlog, tlog)
        if jtok is not None:
            assert np.array_equal(jtok, ttok)
    for key in CACHE_KEYS:
        assert _close(jend[key], tend[key]), key


def test_rwkv6_logits_at_every_position_match_reference(rw):
    """A forward without caches is a prefill; its logits hold at every
    position, in the first chunk and past it."""
    jcfg, tcfg, jparams, tparams, prompts, *_ = rw
    jlog, _ = jW.forward(jcfg, jparams, jnp.asarray(prompts))
    with torch.inference_mode():
        tlog, caches = tW.forward(tcfg, tparams, torch.from_numpy(prompts))
    assert tlog.shape == jlog.shape == (BATCH, PROMPT, tcfg.vocab_padded)
    assert set(caches) == set(CACHE_KEYS)
    assert _close(jlog, tlog)


def test_rwkv6_step_matches_reference():
    rng = np.random.RandomState(2)
    r, k, v = (rng.randn(3, 4, 8).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.randn(3, 4, 8) - 4.0).astype(np.float32)
    u = (0.5 * rng.randn(4, 8)).astype(np.float32)
    s = rng.randn(3, 4, 8, 8).astype(np.float32)
    jo, js = jW.wkv6_step(*(jnp.asarray(x) for x in (r, k, v, logw, u, s)))
    to, ts = tW.wkv6_step(*(torch.from_numpy(x)
                            for x in (r, k, v, logw, u, s)))
    assert _close(jo, to, 1e-5) and _close(js, ts, 1e-5)


def test_rwkv6_init_cache_matches_reference():
    jcfg = jconfigs.get(ARCH).reduced()
    tcfg = tconfigs.get(ARCH).reduced()
    jc, _ = jW.init_cache(jcfg, 3)
    tc = tW.init_cache(tcfg, 3)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
        assert not bool(tc[key].any())


def test_convert_round_trip_on_the_rwkv6_tree(rw):
    _, tcfg, jparams, tparams, *_ = rw
    back = params_to_jax(tparams)
    jl, jt = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    bl, bt = jax.tree.flatten(back)
    assert jt == bt
    assert all(np.array_equal(a, b) for a, b in zip(jl, bl))
    # the port's own init has the reference's tree, shapes and dtypes
    own = params_to_jax(tW.init_rwkv6_model(tcfg,
                                            torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == jt
    assert all(a.shape == b.shape and a.dtype == b.dtype == np.float32
               for a, b in zip(jax.tree.leaves(own), jl))
    # and the reference's constants where it has them
    lay = own["layers"]
    assert np.all(lay["w0"] == -6.0) and np.all(lay["ln_x"] == 1.0)
    assert np.all(lay["ln1"]["scale"] == 1.0) and not lay["mu"].any()
