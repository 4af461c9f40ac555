"""The port's ``lm`` model against the reference on the reduced
``smollm-135m``: the reference's key-0 parameters carried over by
``repro_torch.convert``, the same token batches, f32 activations.  The
loss on the seed batch equals the reference's (5.577058) to 1e-5 and every
gradient equals ``jax.grad``'s to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttr
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors run fastest on one thread (and leave the cores to
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    jparams, _ = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 65), 0,
                                           jcfg.vocab))
    return jcfg, tcfg, jparams, params_from_jax(nparams), tokens


def _tok(tokens):
    return {"tokens": torch.as_tensor(np.array(tokens), dtype=torch.long)}


def test_convert_round_trip_keeps_the_tree(model):
    _, _, jparams, tparams, _ = model
    back = params_to_jax(tparams)
    jl, jt = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    bl, bt = jax.tree.flatten(back)
    assert jt == bt
    assert all(np.array_equal(a, b) for a, b in zip(jl, bl))
    # the port's leaf order is the reference's flatten (ravel) order
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == \
        [a.shape for a in jl]


def test_loss_matches_reference(model):
    jcfg, tcfg, jparams, tparams, tokens = model
    jloss, _ = jtr.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    tloss, aux = ttr.loss_fn(tcfg, tparams, _tok(tokens))
    assert abs(float(jloss) - 5.577058) < 1e-5
    assert abs(float(tloss) - float(jloss)) < 1e-5
    assert float(aux["xent"]) == float(tloss)


def test_grads_match_reference(model):
    jcfg, tcfg, jparams, tparams, tokens = model
    jg = jax.grad(lambda p: jtr.loss_fn(jcfg, p,
                                        {"tokens": jnp.asarray(tokens)})[0]
                  )(jparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = ttr.loss_fn(tcfg, tparams, _tok(tokens))
    tg = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < 1e-4


@pytest.mark.parametrize("seq", [16, 33])
def test_logits_match_reference(model, seq):
    jcfg, tcfg, jparams, tparams, tokens = model
    jlog, _, _ = jtr.forward(jcfg, jparams, jnp.asarray(tokens[:2, :seq]))
    with torch.no_grad():
        tlog = ttr.forward(tcfg, tparams,
                           torch.tensor(tokens[:2, :seq], dtype=torch.long))
    assert np.max(np.abs(np.asarray(jlog) - tlog.numpy())) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,window", [(16, 4, 2, None), (24, 4, 4, 8),
                                           (9, 6, 3, None)])
def test_sdpa_matches_reference(s, h, kv, window, dtype):
    rng = np.random.RandomState(s + h)
    q, k, v = (rng.randn(2, s, n, 32).astype(np.float32)
               for n in (h, kv, kv))
    pos = np.arange(s, dtype=np.int32)
    jcfg = jL.AttnCfg(d_model=h * 32, n_heads=h, n_kv=kv, head_dim=32,
                      window=window)
    tcfg = tL.AttnCfg(d_model=h * 32, n_heads=h, n_kv=kv, head_dim=32,
                      window=window)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = jL.sdpa(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                  jnp.asarray(pos), jnp.asarray(pos), jcfg)
    out = tL.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                  torch.from_numpy(pos), torch.from_numpy(pos), tcfg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.max(np.abs(np.asarray(ref.astype(jnp.float32))
                         - out.float().numpy())) < tol


@pytest.mark.parametrize("s,chunk", [(13, 512), (13, 4), (32, 8)])
def test_chunked_xent_matches_reference(s, chunk):
    rng = np.random.RandomState(s * chunk)
    x = rng.randn(2, s, 16).astype(np.float32)
    table = (rng.randn(64, 16) * 0.3).astype(np.float32)
    labels = rng.randint(0, 60, (2, s)).astype(np.int32)
    labels[1, -3:] = -1                       # padding labels
    ref = jL.chunked_unembed_xent({"table": jnp.asarray(table)},
                                  jnp.asarray(x), jnp.asarray(labels), 60,
                                  chunk=chunk)
    out = tL.chunked_unembed_xent({"table": torch.from_numpy(table)},
                                  torch.from_numpy(x),
                                  torch.from_numpy(labels).long(), 60,
                                  chunk=chunk)
    assert abs(float(ref) - float(out)) < 1e-5


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    scale = rng.rand(16).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    assert np.max(np.abs(
        np.asarray(jL.rope(jnp.asarray(x), jnp.asarray(pos)))
        - tL.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy())) < 1e-5
    assert np.max(np.abs(
        np.asarray(jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
        - tL.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x)).numpy())) < 1e-5


def test_port_init_has_the_reference_tree_and_scales():
    cfg = tconfigs.get("smollm-135m").reduced()
    jcfg = jconfigs.get("smollm-135m").reduced()
    tp = ttr.init_lm(cfg, torch.Generator().manual_seed(0))
    jp, _ = jtr.init_lm(jcfg, jax.random.PRNGKey(0))
    assert jax.tree.structure(params_to_jax(tp)) == \
        jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
        # per-layer fan-in scale: std within 20% of the reference's
        sa, sb = float(np.std(np.asarray(a))), float(b.std())
        assert (sa == 0) == (sb == 0)
        if sa > 0:
            assert abs(sb / sa - 1) < 0.2
