"""The port's unified model API (``models/api.py``) and ``make_batch_for``
against the reference's, for all ten configs, on the CPU.

- ``build`` at ``reduced()``: the port's own init has the reference's
  tree, shapes and dtypes; ``loss_fn`` on the reference's key-0
  parameters equals the reference's loss (1e-5, f32) and, on the port's
  own init, is finite with non-zero gradients; ``decode_fn`` after
  ``init_cache`` gives finite ``(gb, vocab_padded)`` logits (these mirror
  ``tests/test_models.py``).  The losses of ``rglru`` and ``rwkv6``, which
  only this API carries, are also held to ``jax.grad`` (1e-4).
- ``input_specs`` and ``batch_axes`` at full size for every config and
  every ``LM_SHAPES`` entry: the ``meta`` tensors' shapes and dtypes
  against the reference's ``ShapeDtypeStruct``\\ s, the axes equal.
- ``make_batch_for``: the port's numpy arrays equal the reference's bit
  for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import LM_SHAPES as J_SHAPES
from repro.data.pipeline import make_batch_for as j_make_batch_for
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.configs.base import LM_SHAPES, ArchConfig, ShapeSpec
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import make_batch_for
from repro_torch.models import api as tapi
from repro_torch.optim.adamw import tree_leaves

NAMES = sorted(jconfigs.ARCHS)
GB, S = 2, 48
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, lib):
    """The batch of ``tests/test_models.py``, from numpy: tokens (GB, S+1)
    and, per family, frames or patches."""
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (GB, S + 1))
    out = {"tokens": tokens}
    if cfg.family == "encdec":
        out["frames"] = np.ones((GB, S, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        out["patches"] = np.ones((GB, cfg.n_img_tokens, cfg.d_model),
                                 np.float32)
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {k: conv(v) for k, v in out.items()}


def _ref_params(jcfg):
    jparams, _ = japi.build(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.array(a, copy=True), jparams)


def test_the_port_builds_all_ten():
    assert sorted(tconfigs.ARCHS) == NAMES
    assert {tapi.build(tconfigs.get(n)).cfg.family for n in NAMES} == \
        {"lm", "moe", "encdec", "vlm", "rglru", "rwkv6"}
    assert tapi.ENC_LEN_FOR_DECODE == japi.ENC_LEN_FOR_DECODE
    with pytest.raises(ValueError, match="unknown family"):
        tapi.build(ArchConfig(name="x", family="cnn", n_layers=1, d_model=8,
                              n_heads=1, n_kv=1, d_ff=8, vocab=8))


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_is_the_references(name):
    nparams = _ref_params(jconfigs.get(name).reduced())
    own = params_to_jax(tapi.build(tconfigs.get(name).reduced()).init(
        torch.Generator().manual_seed(0)))
    nl, nt = jax.tree.flatten(nparams)
    assert jax.tree.structure(own) == nt
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(jax.tree.leaves(own), nl))


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_reference(name):
    jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    nparams = _ref_params(jcfg)
    jloss, jm = japi.build(jcfg).loss_fn(
        jax.tree.map(jnp.asarray, nparams), _batch(jcfg, "jax"))
    with torch.no_grad():
        tloss, tm = tapi.build(tcfg).loss_fn(params_from_jax(nparams),
                                             _batch(tcfg, "torch"))
    assert tloss.shape == () and set(tm) == set(jm)
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL


@pytest.mark.parametrize("name", NAMES)
def test_loss_on_own_init_is_finite_with_nonzero_grads(name):
    api = tapi.build(tconfigs.get(name).reduced())
    params = api.init(torch.Generator().manual_seed(0))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = api.loss_fn(params, _batch(api.cfg, "torch"))
    assert loss.shape == () and bool(torch.isfinite(loss))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    gsum = sum(float(g.abs().sum()) for g in grads if g is not None)
    assert gsum > 0 and np.isfinite(gsum)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-7b"])
def test_recurrent_loss_grads_match_reference(name):
    jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    nparams = _ref_params(jcfg)
    jb = _batch(jcfg, "jax")
    jg = jax.grad(lambda p: japi.build(jcfg).loss_fn(p, jb)[0])(
        jax.tree.map(jnp.asarray, nparams))
    tparams = params_from_jax(nparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = tapi.build(tcfg).loss_fn(tparams, _batch(tcfg, "torch"))
    tg = torch.autograd.grad(loss, leaves)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        assert a.shape == tuple(b.shape)
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < GRAD_TOL


@pytest.mark.parametrize("name", NAMES)
def test_decode_fn_shapes(name):
    api = tapi.build(tconfigs.get(name).reduced())
    cfg = api.cfg
    params = api.init(torch.Generator().manual_seed(0))
    caches = api.init_cache(GB, 64)
    batch = {"tokens": torch.zeros((GB, 1), dtype=torch.int32),
             "cache_len": torch.tensor(0, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["cross_k"] = torch.zeros((cfg.n_dec_layers, GB, 16, cfg.n_kv,
                                        cfg.head_dim_), dtype=torch.bfloat16)
        batch["cross_v"] = batch["cross_k"]
    with torch.inference_mode():
        logits, _ = api.decode_fn(params, caches, batch)
    assert tuple(logits.shape) == (GB, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())


def _dtype_name(t):
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape", [s.name for s in LM_SHAPES])
@pytest.mark.parametrize("name", NAMES)
def test_input_specs_and_batch_axes_equal_reference(name, shape):
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    jshape, tshape = jcfg.shape(shape), tcfg.shape(shape)
    assert (tshape.seq_len, tshape.global_batch, tshape.kind) == \
        (jshape.seq_len, jshape.global_batch, jshape.kind)
    jspecs = japi.build(jcfg).input_specs(jshape)
    tspecs = tapi.build(tcfg).input_specs(tshape)
    assert list(tspecs) == list(jspecs)
    for k, j in jspecs.items():
        t = tspecs[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == j.shape, k
        assert _dtype_name(t) == np.dtype(j.dtype).name, k
    assert tapi.build(tcfg).batch_axes(tshape) == \
        japi.build(jcfg).batch_axes(jshape)


def test_lm_shapes_and_skips_equal_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in LM_SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in J_SHAPES]
    for n in NAMES:
        assert [s.name for s in tconfigs.get(n).shapes] == \
            [s.name for s in jconfigs.get(n).shapes]
    with pytest.raises(KeyError):
        tconfigs.get(NAMES[0]).shape("no_such_shape")


@pytest.mark.parametrize("name", NAMES)
def test_make_batch_for_equals_reference_bit_for_bit(name):
    jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    for seq, gb, step, seed, hosts, host in ((48, 4, 0, 0, 1, 0),
                                             (40, 4, 3, 7, 2, 1)):
        args = (step, seed, hosts, host)
        jb = j_make_batch_for(jcfg, type(J_SHAPES[0])("t", seq, gb, "train"),
                              *args)
        tb = make_batch_for(tcfg, ShapeSpec("t", seq, gb, "train"), *args)
        assert list(tb) == list(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            assert np.array_equal(tb[k], jb[k]), k
    with pytest.raises(ValueError, match="training-data helper"):
        make_batch_for(tcfg, LM_SHAPES[1])
