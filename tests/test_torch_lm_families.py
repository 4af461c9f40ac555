"""The port's ``lm`` attention options (qkv bias, qk-norm) and ``moe``
family against the reference, on the CPU in f32, for the five configs
this adds: qwen2-7b (qkv bias), qwen3-8b (qk-norm), mistral-nemo-12b,
olmoe-1b-7b (qk-norm, 64 experts top-8) and qwen2-moe-a2.7b (qkv bias,
60 experts padded to 64, 4 shared), each at ``reduced()``.

Both sides start from the reference's key-0 parameters (carried over by
``repro_torch.convert``), with the bias and norm leaves overwritten by
seeded numpy values (biases N(0, 0.5^2), norm scales in [0.5, 1.5]): the
init's zero biases and unit scales would let a port that never adds the
bias or scales the norm pass.  Checked: the forward logits, a prefill's
last logits and KV cache, one decode step, ``loss_fn`` with its aux
metrics, and every gradient against ``jax.grad``; the ``convert`` round
trip of each new tree; and the stacked init of the ``lm``, ``rglru`` and
``rwkv6`` families against the per-layer ``torch.stack`` it replaced,
bit for bit.

Tolerances (those of ``test_torch_model.py`` and ``test_torch_serve.py``):
logits to 1e-4, the loss to 1e-5, gradients to 1e-4, the first layer's
bf16 KV cache to one bf16 rounding, greedy tokens identical; the MoE aux
losses to 1e-6 of max(1, |loss|), as ``test_torch_moe.py`` holds them.
A deeper layer's cache is held to one bf16 rounding plus 1e-3: both
sides attend over their own bf16 caches, so a key of the first layer
that rounds the other way (its f32 values differ in the last bits) moves
that layer's output, and with it the next layer's f32 keys before their
rounding, by more than one rounding of a small key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import layers as tL
from repro_torch.models import rglru as tG
from repro_torch.models import rwkv6 as tW
from repro_torch.models import transformer as tT
from repro_torch.optim.adamw import tree_leaves

ARCHS = ["qwen2-7b", "qwen3-8b", "mistral-nemo-12b", "olmoe-1b-7b",
         "qwen2-moe-a2.7b"]
PROMPT, BATCH = 40, 2
TOL, LOSS_TOL, GRAD_TOL, AUX_TOL = 1e-4, 1e-5, 1e-4, 1e-6
BF16_RTOL = 2.0 ** -7        # one bf16 rounding of either side
AUX = {"moe_load_balance", "moe_router_z"}
DEEP_ATOL = 1e-3             # a deeper layer's cache: see the docstring


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


def _assert_cache_close(jcache, tcache):
    for jc, tc in zip(jcache, tcache):
        assert tuple(tc.shape) == jc.shape and tc.dtype == torch.bfloat16
        for layer in range(jc.shape[0]):
            np.testing.assert_allclose(
                _np(tc[layer]), _np(jc[layer]), rtol=BF16_RTOL,
                atol=1e-6 if layer == 0 else DEEP_ATOL)


def _randomise(nparams, seed):
    """Seeded values in place of the init's zero biases and unit qk-norm
    scales; returns the names overwritten."""
    rng = np.random.RandomState(seed)
    attn = nparams["layers"]["attn"]
    done = []
    for k in ("bq", "bk", "bv"):
        if k in attn:
            attn[k] = (rng.standard_normal(attn[k].shape) * 0.5
                       ).astype(np.float32)
            done.append(k)
    for k in ("q_norm", "k_norm"):
        if k in attn:
            attn[k] = rng.uniform(0.5, 1.5, attn[k].shape).astype(np.float32)
            done.append(k)
    return done


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jcfg = jconfigs.get(arch).reduced()
    tcfg = tconfigs.get(arch).reduced()
    jparams, _ = jT.init_lm(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(lambda a: np.array(a, copy=True), jparams)
    changed = _randomise(nparams, seed=ARCHS.index(arch))
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab,
                                              (BATCH, PROMPT + 1))
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, nparams=nparams,
                jparams=jax.tree.map(jnp.asarray, nparams),
                tparams=params_from_jax(nparams), changed=changed,
                tokens=tokens)


def test_each_config_has_its_attention_options(fam):
    tcfg, changed = fam["tcfg"], fam["changed"]
    expect = {"qwen2-7b": ["bq", "bk", "bv"],
              "qwen3-8b": ["q_norm", "k_norm"], "mistral-nemo-12b": [],
              "olmoe-1b-7b": ["q_norm", "k_norm"],
              "qwen2-moe-a2.7b": ["bq", "bk", "bv"]}[fam["arch"]]
    assert changed == expect
    assert ("moe" in fam["tparams"]["layers"]) == tcfg.is_moe
    assert ("mlp" in fam["tparams"]["layers"]) != tcfg.is_moe
    if fam["arch"] == "qwen2-moe-a2.7b":
        assert set(fam["tparams"]["layers"]["moe"]["shared"]) == \
            {"wi_gate", "wi_up", "wo", "gate"}


def test_forward_logits_match_reference(fam):
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    toks = fam["tokens"][:, :PROMPT]
    jlog, _, _ = jT.forward(jcfg, fam["jparams"], jnp.asarray(toks))
    with torch.inference_mode():
        tlog = tT.forward(tcfg, fam["tparams"], torch.from_numpy(toks))
        # the randomised leaves are read: the init's zeros and ones give
        # other logits
        init = params_from_jax(jax.tree.map(
            np.asarray, jT.init_lm(jcfg, jax.random.PRNGKey(0))[0]))
        tlog0 = tT.forward(tcfg, init, torch.from_numpy(toks))
    assert tlog.shape == jlog.shape == (BATCH, PROMPT, tcfg.vocab_padded)
    assert _maxdiff(jlog, tlog) < TOL
    if fam["changed"]:
        assert _maxdiff(tlog0, tlog) > 1e-2


def test_prefill_and_decode_match_reference(fam):
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    jp, tp = fam["jparams"], fam["tparams"]
    prompts = fam["tokens"][:, :PROMPT]
    max_len = PROMPT + 2
    jlog, jcache = jT.prefill(jcfg, jp, jnp.asarray(prompts), max_len)
    with torch.inference_mode():
        tlog, tcache = tT.prefill(tcfg, tp, torch.from_numpy(prompts),
                                  max_len)
        assert _maxdiff(jlog, tlog) < TOL
        _assert_cache_close(jcache, tcache)
        jtok = jnp.argmax(jlog[..., :jcfg.vocab], axis=-1)[:, None]
        ttok = tlog[..., :tcfg.vocab].argmax(-1)[:, None]
        assert np.array_equal(np.asarray(jtok), ttok.numpy())
        jlog2, jcache = jT.decode_step(jcfg, jp, jcache, jtok,
                                       jnp.int32(PROMPT))
        tlog2, tcache = tT.decode_step(tcfg, tp, tcache, ttok, PROMPT)
    assert _maxdiff(jlog2, tlog2) < TOL
    _assert_cache_close(jcache, tcache)


def test_loss_and_aux_match_reference(fam):
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    jloss, jm = jT.loss_fn(jcfg, fam["jparams"],
                           {"tokens": jnp.asarray(fam["tokens"])})
    with torch.no_grad():
        tloss, tm = tT.loss_fn(tcfg, fam["tparams"],
                               {"tokens": torch.from_numpy(fam["tokens"])})
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL
    assert float(tm["xent"]) == float(tloss)
    assert set(tm) == set(jm) == ({"xent"} | (AUX if tcfg.is_moe else set()))
    for k in set(jm) - {"xent"}:
        assert abs(float(tm[k]) - float(jm[k])) < \
            AUX_TOL * max(1.0, abs(float(jm[k]))), k


def test_grads_match_reference(fam):
    jcfg, tcfg = fam["jcfg"], fam["tcfg"]
    batch = {"tokens": jnp.asarray(fam["tokens"])}
    jg = jax.grad(lambda p: jT.loss_fn(jcfg, p, batch)[0])(fam["jparams"])
    tparams = params_from_jax(fam["nparams"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss, _ = tT.loss_fn(tcfg, tparams,
                         {"tokens": torch.from_numpy(fam["tokens"])})
    tg = torch.autograd.grad(loss, leaves)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        assert a.shape == tuple(b.shape)
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < GRAD_TOL


def test_convert_round_trip_on_the_new_tree(fam):
    back = params_to_jax(fam["tparams"])
    nl, nt = jax.tree.flatten(fam["nparams"])
    bl, bt = jax.tree.flatten(back)
    assert nt == bt
    assert all(np.array_equal(a, b) for a, b in zip(nl, bl))
    # and back again: the tensors of a round trip are the tensors
    again = params_from_jax(back)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(again), tree_leaves(fam["tparams"])))
    # the port's own init has the reference's tree, shapes and dtypes
    own = params_to_jax(tT.init_lm(fam["tcfg"],
                                   torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == nt
    assert all(a.shape == b.shape and a.dtype == b.dtype == np.float32
               for a, b in zip(jax.tree.leaves(own), nl))


# -- the stacked init against the torch.stack of per-layer trees it replaced

def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _old_lm(cfg, gen):
    return {"embed": tL.init_embedding(gen, cfg.vocab_padded, cfg.d_model),
            "layers": _stack([tT.init_layer(cfg, gen)
                              for _ in range(cfg.n_layers)]),
            "final_norm": tL.init_rmsnorm(cfg.d_model)}


def _old_rglru(cfg, gen):
    kinds = tG._layer_kinds(cfg)
    n_rec = sum(k == "rec" for k in kinds)
    n_att = max(sum(k == "attn" for k in kinds), 1)
    d = cfg.d_model
    return {
        "embed": tL.init_embedding(gen, cfg.vocab_padded, d),
        "rec": _stack([tG.init_rec_layer(cfg, gen) for _ in range(n_rec)]),
        "att": _stack([{"ln": tL.init_rmsnorm(d),
                        "attn": tL.init_attention(gen, tT.attn_cfg(cfg))}
                       for _ in range(n_att)]),
        "mlp": _stack([{"ln": tL.init_rmsnorm(d),
                        "mlp": tL.init_glu_mlp(gen, d, cfg.d_ff)}
                       for _ in range(cfg.n_layers)]),
        "final_norm": tL.init_rmsnorm(d)}


def _old_rwkv6(cfg, gen):
    return {"embed": tL.init_embedding(gen, cfg.vocab_padded, cfg.d_model),
            "layers": _stack([tW.init_layer(cfg, gen)
                              for _ in range(cfg.n_layers)]),
            "final_norm": tL.init_layernorm(cfg.d_model)}


@pytest.mark.parametrize("arch,new,old", [
    ("smollm-135m", tT.init_lm, _old_lm),
    ("qwen2-moe-a2.7b", tT.init_lm, _old_lm),
    ("recurrentgemma-2b", tG.init_rglru_model, _old_rglru),
    ("rwkv6-7b", tW.init_rwkv6_model, _old_rwkv6),
], ids=["lm", "moe", "rglru", "rwkv6"])
def test_stacked_init_equals_the_old_one_bit_for_bit(arch, new, old):
    cfg = tconfigs.get(arch).reduced()
    a = new(cfg, torch.Generator().manual_seed(5))
    b = old(cfg, torch.Generator().manual_seed(5))
    la, lb = tree_leaves(a), tree_leaves(b)
    assert params_to_jax(a).keys() == params_to_jax(b).keys()
    assert len(la) == len(lb)
    assert all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(la, lb))


def test_init_stacked_fills_in_call_order():
    calls = iter(range(3))

    def make():
        i = next(calls)
        return {"w": torch.full((2,), float(i)), "n": {"b": torch.tensor(i)}}

    out = tL.init_stacked(make, 3)
    assert torch.equal(out["w"], torch.tensor([[0.0, 0.0], [1.0, 1.0],
                                               [2.0, 2.0]]))
    assert torch.equal(out["n"]["b"], torch.tensor([0, 1, 2]))
