"""The port's ``vlm`` family (internvl2-2b at ``reduced()``: 2 layers, d
128, 4 heads over 4, 8 image tokens) against the reference, on the CPU in
f32.

Both sides start from the reference's key-0 parameters (carried over by
``repro_torch.convert``) with every RMS norm's scale overwritten by
seeded numpy values (the init's ones would let a port that skips them
pass), and the same numpy patches and tokens (a 40-token text prompt
after the 8 patches: 48 positions, the image prefix causal with the
text).  Checked: the forward logits; ``api``'s cache-less prefill; an f32
cache filled by ``forward`` at ``cache_len`` 0 followed by three greedy
``api.decode_fn`` steps; the loss (text positions only) and every
gradient against ``jax.grad``; prefill then decode against the
cache-less prefill of the longer prompt; the parameter tree.  Each
prefill runs on both of the port's paths: ``fresh`` (the flash kernel's
plain version) and the plain ``sdpa``.

Tolerances (those of ``test_torch_lm_families.py``): logits 1e-4, loss
1e-5, gradients 1e-4, greedy tokens identical; the caches are f32, as in
``test_torch_encdec.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import vlm as jV
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.models import vlm as tV
from repro_torch.optim.adamw import tree_leaves

ARCH = "internvl2-2b"
BATCH, PROMPT, STEPS = 2, 40, 3
TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
PATHS = ["fresh", "sdpa"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _maxdiff(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _randomise_scales(tree, rng):
    """Seeded scales in [0.5, 1.5] for every RMS norm (a dict of exactly
    ``scale``) of a numpy tree, in place; returns how many."""
    n = 0
    for v in tree.values():
        if isinstance(v, dict) and set(v) == {"scale"}:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape) \
                .astype(np.float32)
            n += 1
        elif isinstance(v, dict):
            n += _randomise_scales(v, rng)
    return n


@pytest.fixture(scope="module")
def vl():
    jcfg = jconfigs.get(ARCH).reduced()
    tcfg = tconfigs.get(ARCH).reduced()
    jparams, _ = jV.init_vlm(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(lambda a: np.array(a, copy=True), jparams)
    assert _randomise_scales(nparams, np.random.RandomState(12)) == 3
    rng = np.random.RandomState(4)
    patches = rng.standard_normal((BATCH, jcfg.n_img_tokens, jcfg.d_model)) \
        .astype(np.float32)
    tokens = rng.randint(0, jcfg.vocab, (BATCH, PROMPT + 1))
    return dict(jcfg=jcfg, tcfg=tcfg, nparams=nparams,
                jparams=jax.tree.map(jnp.asarray, nparams),
                tparams=params_from_jax(nparams), patches=patches,
                tokens=tokens)


def test_the_reduced_config_is_the_references(vl):
    jcfg, tcfg = vl["jcfg"], vl["tcfg"]
    assert tcfg.family == "vlm" and tcfg.n_img_tokens == 8
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv,
            tcfg.head_dim_) == (jcfg.n_layers, jcfg.d_model, jcfg.n_heads,
                                jcfg.n_kv, jcfg.head_dim_)


@pytest.mark.parametrize("path", PATHS)
def test_forward_logits_match_reference(vl, path):
    toks = vl["tokens"][:, :PROMPT]
    jlog, _ = jV.forward(vl["jcfg"], vl["jparams"], jnp.asarray(toks),
                         jnp.asarray(vl["patches"]))
    with torch.inference_mode():
        tlog, _ = tV.forward(vl["tcfg"], vl["tparams"],
                             torch.from_numpy(toks),
                             torch.from_numpy(vl["patches"]),
                             fresh=path == "fresh")
    assert tuple(tlog.shape) == jlog.shape == (BATCH, 8 + PROMPT, 256)
    assert _maxdiff(jlog, tlog) < TOL


def _prefill(vl, tokens, path):
    """The port's cache-less prefill: ``api.prefill_fn`` (fresh) or
    ``forward`` on the plain ``sdpa``."""
    tcfg, tp = vl["tcfg"], vl["tparams"]
    patches, toks = torch.from_numpy(vl["patches"]), \
        torch.from_numpy(tokens)
    with torch.inference_mode():
        if path == "fresh":
            return tapi.build(tcfg).prefill_fn(
                tp, {"patches": patches, "tokens": toks})
        logits, _ = tV.forward(tcfg, tp, toks, patches, last_only=True)
        return logits[:, -1], None


@pytest.mark.parametrize("path", PATHS)
def test_prefill_logits_match_reference(vl, path):
    prompts = vl["tokens"][:, :PROMPT]
    jlog, jcache = japi.build(vl["jcfg"]).prefill_fn(
        vl["jparams"], {"patches": jnp.asarray(vl["patches"]),
                        "tokens": jnp.asarray(prompts)})
    tlog, tcache = _prefill(vl, prompts, path)
    assert jcache is None and tcache is None
    assert tuple(tlog.shape) == jlog.shape == (BATCH, 256)
    assert _maxdiff(jlog, tlog) < TOL


@pytest.mark.parametrize("path", PATHS)
def test_cache_fill_and_decode_steps_match_reference(vl, path):
    jcfg, tcfg, jp, tp = vl["jcfg"], vl["tcfg"], vl["jparams"], \
        vl["tparams"]
    prompts = vl["tokens"][:, :PROMPT]
    n = jcfg.n_img_tokens + PROMPT
    max_len = n + STEPS + 1
    jc, _ = jV.init_cache(jcfg, BATCH, max_len, dtype=jnp.float32)
    jlog, jc = jV.forward(jcfg, jp, jnp.asarray(prompts),
                          jnp.asarray(vl["patches"]), cache=jc,
                          cache_len=jnp.int32(0), last_only=True)
    jlog = jlog[:, -1]
    japi_, tapi_ = japi.build(jcfg), tapi.build(tcfg)
    with torch.inference_mode():
        tc = tapi_.init_cache(BATCH, max_len)
        assert tc[0].dtype == torch.bfloat16    # the served default
        tc = tV.init_cache(tcfg, BATCH, max_len, dtype=torch.float32)
        tlog, tc = tV.forward(tcfg, tp, torch.from_numpy(prompts),
                              torch.from_numpy(vl["patches"]), cache=tc,
                              cache_len=0, last_only=True,
                              fresh=path == "fresh")
        tlog = tlog[:, -1]
        assert tuple(tc[0].shape) == jc[0].shape
        for i in range(STEPS + 1):
            assert _maxdiff(jlog, tlog) < TOL, i
            jtok = jnp.argmax(jlog[..., :jcfg.vocab], axis=-1)[:, None]
            ttok = tlog[..., :tcfg.vocab].argmax(-1)[:, None]
            assert np.array_equal(np.asarray(jtok), ttok.numpy()), i
            if i == STEPS:
                break
            jlog, jc = japi_.decode_fn(jp, jc, {
                "tokens": jtok, "cache_len": jnp.int32(n + i)})
            tlog, tc = tapi_.decode_fn(tp, tc, {"tokens": ttok,
                                                "cache_len": n + i})


@pytest.mark.parametrize("path", PATHS)
def test_prefill_then_decode_equals_the_longer_prefill(vl, path):
    """One decode step after a cache fill gives the last logits of a
    cache-less prefill of the prompt plus that token (and the
    reference's)."""
    tcfg, tp = vl["tcfg"], vl["tparams"]
    prompts = vl["tokens"][:, :PROMPT]
    n = tcfg.n_img_tokens + PROMPT
    with torch.inference_mode():
        cache = tV.init_cache(tcfg, BATCH, n + 1, dtype=torch.float32)
        logits, cache = tV.forward(tcfg, tp, torch.from_numpy(prompts),
                                   torch.from_numpy(vl["patches"]),
                                   cache=cache, cache_len=0, last_only=True,
                                   fresh=path == "fresh")
        tok = logits[:, -1, :tcfg.vocab].argmax(-1)[:, None]
        step, _ = tapi.build(tcfg).decode_fn(tp, cache, {"tokens": tok,
                                                         "cache_len": n})
    longer = np.concatenate([prompts, tok.numpy()], axis=1)
    full, _ = _prefill(vl, longer, path)
    jfull, _ = japi.build(vl["jcfg"]).prefill_fn(
        vl["jparams"], {"patches": jnp.asarray(vl["patches"]),
                        "tokens": jnp.asarray(longer)})
    assert _maxdiff(full, step) < TOL
    assert _maxdiff(jfull, step) < TOL


def _batch(vl, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {"patches": conv(vl["patches"]), "tokens": conv(vl["tokens"])}


def test_loss_matches_reference(vl):
    jloss, jm = jV.loss_fn(vl["jcfg"], vl["jparams"], _batch(vl, "jax"))
    with torch.no_grad():
        tloss, tm = tapi.build(vl["tcfg"]).loss_fn(vl["tparams"],
                                                   _batch(vl, "torch"))
    assert set(tm) == set(jm) == {"xent"}
    assert float(tm["xent"]) == float(tloss)
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL


def test_loss_reads_text_positions_only(vl):
    """The labels are the text's: moving a patch changes the loss (the
    text attends to it), but the loss is that of PROMPT tokens."""
    tcfg, tp = vl["tcfg"], vl["tparams"]
    b = _batch(vl, "torch")
    with torch.no_grad():
        hidden, _ = tV.forward(tcfg, tp, b["tokens"][:, :-1], b["patches"],
                               return_hidden=True)
        text = tL.chunked_unembed_xent(tp["embed"], hidden[:, 8:],
                                       b["tokens"][:, 1:], tcfg.vocab)
        loss, _ = tV.loss_fn(tcfg, tp, b)
        moved = dict(b, patches=b["patches"] * 2.0)
        loss2, _ = tV.loss_fn(tcfg, tp, moved)
    assert hidden.shape[1] == 8 + PROMPT
    assert float(loss) == float(text)
    assert abs(float(loss2) - float(loss)) > 1e-6


def test_grads_match_reference(vl):
    jcfg, tcfg = vl["jcfg"], vl["tcfg"]
    jg = jax.grad(lambda p: jV.loss_fn(jcfg, p, _batch(vl, "jax"))[0])(
        vl["jparams"])
    tparams = params_from_jax(vl["nparams"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = tV.loss_fn(tcfg, tparams, _batch(vl, "torch"))
    tg = torch.autograd.grad(loss, leaves)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        assert a.shape == tuple(b.shape)
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < GRAD_TOL


def test_parameter_tree_is_the_references(vl):
    nl, nt = jax.tree.flatten(vl["nparams"])
    bl, bt = jax.tree.flatten(params_to_jax(vl["tparams"]))
    assert nt == bt and all(np.array_equal(a, b) for a, b in zip(nl, bl))
    own = params_to_jax(tV.init_vlm(vl["tcfg"],
                                    torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == nt
    assert set(own) == {"embed", "layers", "final_norm", "patch_proj"}
    assert all(a.shape == b.shape and a.dtype == b.dtype == np.float32
               for a, b in zip(jax.tree.leaves(own), nl))
