"""The port's ``encdec`` family (seamless-m4t-large-v2 at ``reduced()``:
2 encoder and 2 decoder layers, d 128, 4 heads over 4) against the
reference, on the CPU in f32.

Both sides start from the reference's key-0 parameters (carried over by
``repro_torch.convert``) with every layer norm's scale and bias
overwritten by seeded numpy values (the init's ones and zeros would let a
port that skips them pass), and the same numpy frames (96 of them: two
of the reference's 64-key blocks) and tokens (a 40-token prompt).
Checked: ``encode``; ``cross_kv``; ``api``'s cache-less prefill; an f32
self cache filled by ``decode`` at ``cache_len`` 0 followed by three
greedy ``api.decode_fn`` steps; the loss and every gradient against
``jax.grad``; prefill then decode against the cache-less prefill of the
longer prompt; the parameter tree.
Each prefill runs on both of the port's paths: ``fresh`` (the flash
kernel's plain version, non-causal for the encoder and the
cross-attention) and the plain ``sdpa``.

Tolerances (those of ``test_torch_lm_families.py``): logits 1e-4, loss
1e-5, gradients 1e-4, the encoder output and cross K/V 1e-4, greedy
tokens identical.  The caches are f32: with the served bf16 cache a key
whose f32 value differs from the reference's in its last bits may round
the other way (3 of layer 0's 11264 here), which moves the next layer's
keys and the logits (by 1.07e-4 here, where the f32 cache's logits
differ by 5e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import encdec as jE
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tE
from repro_torch.optim.adamw import tree_leaves

ARCH = "seamless-m4t-large-v2"
BATCH, S_ENC, PROMPT, STEPS = 2, 96, 40, 3
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


def randomise_norms(tree, rng):
    """Seeded scales in [0.5, 1.5] and biases N(0, 0.1^2) for every layer
    norm (a dict of exactly ``scale`` and ``bias``) of a numpy tree, in
    place; returns how many."""
    n = 0
    for v in tree.values():
        if isinstance(v, dict) and set(v) == {"scale", "bias"}:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape) \
                .astype(np.float32)
            v["bias"] = (rng.standard_normal(v["bias"].shape) * 0.1) \
                .astype(np.float32)
            n += 1
        elif isinstance(v, dict):
            n += randomise_norms(v, rng)
    return n


@pytest.fixture(scope="module")
def ed():
    jcfg = jconfigs.get(ARCH).reduced()
    tcfg = tconfigs.get(ARCH).reduced()
    jparams, _ = jE.init_encdec(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(lambda a: np.array(a, copy=True), jparams)
    assert randomise_norms(nparams, np.random.RandomState(11)) == 7
    rng = np.random.RandomState(3)
    frames = rng.standard_normal((BATCH, S_ENC, jcfg.d_model)) \
        .astype(np.float32)
    tokens = rng.randint(0, jcfg.vocab, (BATCH, PROMPT + 1))
    jp = jax.tree.map(jnp.asarray, nparams)
    return dict(jcfg=jcfg, tcfg=tcfg, nparams=nparams, jparams=jp,
                tparams=params_from_jax(nparams), frames=frames,
                tokens=tokens,
                jenc=jE.encode(jcfg, jp, jnp.asarray(frames)))


def test_the_reduced_config_is_the_references(ed):
    jcfg, tcfg = ed["jcfg"], ed["tcfg"]
    assert tcfg.family == "encdec" and tcfg.norm_kind == "layernorm"
    assert (tcfg.n_layers, tcfg.n_dec_layers, tcfg.d_model, tcfg.n_heads,
            tcfg.n_kv, tcfg.head_dim_) == (jcfg.n_layers, jcfg.n_dec_layers,
                                           jcfg.d_model, jcfg.n_heads,
                                           jcfg.n_kv, jcfg.head_dim_)


@pytest.mark.parametrize("path", PATHS)
def test_encode_matches_reference(ed, path):
    with torch.inference_mode():
        out = tE.encode(ed["tcfg"], ed["tparams"],
                        torch.from_numpy(ed["frames"]),
                        fresh=path == "fresh")
    assert tuple(out.shape) == ed["jenc"].shape == (BATCH, S_ENC, 128)
    assert _maxdiff(ed["jenc"], out) < TOL


def test_cross_kv_matches_reference(ed):
    jck, jcv = jE.cross_kv(ed["jcfg"], ed["jparams"], ed["jenc"])
    with torch.inference_mode():
        tck, tcv = tE.cross_kv(ed["tcfg"], ed["tparams"],
                               torch.tensor(_np(ed["jenc"])))
    for j, t in ((jck, tck), (jcv, tcv)):
        assert tuple(t.shape) == j.shape == (2, BATCH, S_ENC, 4, 32)
        assert _maxdiff(j, t) < TOL


def _prefill(ed, tokens, path):
    """The port's cache-less prefill: ``api.prefill_fn`` (fresh) or
    ``encode`` and ``decode`` on the plain ``sdpa``."""
    tcfg, tp = ed["tcfg"], ed["tparams"]
    frames, toks = torch.from_numpy(ed["frames"]), torch.from_numpy(tokens)
    with torch.inference_mode():
        if path == "fresh":
            return tapi.build(tcfg).prefill_fn(
                tp, {"frames": frames, "tokens": toks})
        enc = tE.encode(tcfg, tp, frames)
        logits, cache = tE.decode(tcfg, tp, toks, enc, last_only=True)
        return logits[:, -1], cache


@pytest.mark.parametrize("path", PATHS)
def test_prefill_logits_match_reference(ed, path):
    prompts = ed["tokens"][:, :PROMPT]
    jlog, jcache = japi.build(ed["jcfg"]).prefill_fn(
        ed["jparams"], {"frames": jnp.asarray(ed["frames"]),
                        "tokens": jnp.asarray(prompts)})
    tlog, tcache = _prefill(ed, prompts, path)
    assert jcache is None and tcache is None
    assert tuple(tlog.shape) == jlog.shape == (BATCH, 256)
    assert _maxdiff(jlog, tlog) < TOL


@pytest.mark.parametrize("path", PATHS)
def test_cache_fill_and_decode_steps_match_reference(ed, path):
    jcfg, tcfg, jp, tp = ed["jcfg"], ed["tcfg"], ed["jparams"], \
        ed["tparams"]
    prompts = ed["tokens"][:, :PROMPT]
    max_len = PROMPT + STEPS + 1
    jckv = jE.cross_kv(jcfg, jp, ed["jenc"])
    (jc, _) = jE.init_cache(jcfg, BATCH, max_len, dtype=jnp.float32)
    jlog, jc = jE.decode(jcfg, jp, jnp.asarray(prompts), self_cache=jc,
                         cache_len=jnp.int32(0), ckv=jckv, last_only=True)
    jlog = jlog[:, -1]
    japi_ = japi.build(jcfg)
    tapi_ = tapi.build(tcfg)
    with torch.inference_mode():
        enc = tE.encode(tcfg, tp, torch.from_numpy(ed["frames"]),
                        fresh=path == "fresh")
        tckv = tE.cross_kv(tcfg, tp, enc)
        tc = tE.init_cache(tcfg, BATCH, max_len, dtype=torch.float32)
        tlog, tc = tE.decode(tcfg, tp, torch.from_numpy(prompts),
                             self_cache=tc, cache_len=0, ckv=tckv,
                             last_only=True, fresh=path == "fresh")
        tlog = tlog[:, -1]
        assert tc[0].dtype == torch.float32
        assert tuple(tc[0].shape) == jc[0].shape
        for i in range(STEPS + 1):
            assert _maxdiff(jlog, tlog) < TOL, i
            jtok = jnp.argmax(jlog[..., :jcfg.vocab], axis=-1)[:, None]
            ttok = tlog[..., :tcfg.vocab].argmax(-1)[:, None]
            assert np.array_equal(np.asarray(jtok), ttok.numpy()), i
            if i == STEPS:
                break
            jlog, jc = japi_.decode_fn(jp, jc, {
                "tokens": jtok, "cache_len": jnp.int32(PROMPT + i),
                "cross_k": jckv[0], "cross_v": jckv[1]})
            tlog, tc = tapi_.decode_fn(tp, tc, {
                "tokens": ttok, "cache_len": PROMPT + i,
                "cross_k": tckv[0], "cross_v": tckv[1]})


@pytest.mark.parametrize("path", PATHS)
def test_prefill_then_decode_equals_the_longer_prefill(ed, path):
    """One decode step after a cache fill gives the last logits of a
    cache-less prefill of the prompt plus that token (and the
    reference's)."""
    tcfg, tp = ed["tcfg"], ed["tparams"]
    prompts = ed["tokens"][:, :PROMPT]
    with torch.inference_mode():
        enc = tE.encode(tcfg, tp, torch.from_numpy(ed["frames"]),
                        fresh=path == "fresh")
        ckv = tE.cross_kv(tcfg, tp, enc)
        cache = tE.init_cache(tcfg, BATCH, PROMPT + 1, dtype=torch.float32)
        logits, cache = tE.decode(tcfg, tp, torch.from_numpy(prompts),
                                  self_cache=cache, cache_len=0, ckv=ckv,
                                  last_only=True, fresh=path == "fresh")
        tok = logits[:, -1, :tcfg.vocab].argmax(-1)[:, None]
        step, _ = tapi.build(tcfg).decode_fn(tp, cache, {
            "tokens": tok, "cache_len": PROMPT, "cross_k": ckv[0],
            "cross_v": ckv[1]})
    longer = np.concatenate([prompts, tok.numpy()], axis=1)
    full, _ = _prefill(ed, longer, path)
    jfull, _ = japi.build(ed["jcfg"]).prefill_fn(
        ed["jparams"], {"frames": jnp.asarray(ed["frames"]),
                        "tokens": jnp.asarray(longer)})
    assert _maxdiff(full, step) < TOL
    assert _maxdiff(jfull, step) < TOL


def _batch(ed, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {"frames": conv(ed["frames"]), "tokens": conv(ed["tokens"])}


def test_loss_matches_reference(ed):
    jloss, jm = jE.loss_fn(ed["jcfg"], ed["jparams"], _batch(ed, "jax"))
    with torch.no_grad():
        tloss, tm = tapi.build(ed["tcfg"]).loss_fn(ed["tparams"],
                                                   _batch(ed, "torch"))
    assert set(tm) == set(jm) == {"xent"}
    assert float(tm["xent"]) == float(tloss)
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL


def test_grads_match_reference(ed):
    jcfg, tcfg = ed["jcfg"], ed["tcfg"]
    jg = jax.grad(lambda p: jE.loss_fn(jcfg, p, _batch(ed, "jax"))[0])(
        ed["jparams"])
    tparams = params_from_jax(ed["nparams"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = tE.loss_fn(tcfg, tparams, _batch(ed, "torch"))
    tg = torch.autograd.grad(loss, leaves)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        assert a.shape == tuple(b.shape)
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < GRAD_TOL


def test_parameter_tree_is_the_references(ed):
    nl, nt = jax.tree.flatten(ed["nparams"])
    bl, bt = jax.tree.flatten(params_to_jax(ed["tparams"]))
    assert nt == bt and all(np.array_equal(a, b) for a, b in zip(nl, bl))
    own = params_to_jax(tE.init_encdec(ed["tcfg"],
                                       torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == nt
    assert set(own) == {"frame_proj", "embed", "enc", "dec", "enc_norm",
                        "dec_norm"}
    assert all(a.shape == b.shape and a.dtype == b.dtype == np.float32
               for a, b in zip(jax.tree.leaves(own), nl))
