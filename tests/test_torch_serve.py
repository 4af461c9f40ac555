"""The port's serving path against the reference, on the CPU in f32.

Both start from the reference's key-0 parameters (carried over by
``repro_torch.convert``) and the same numpy prompts.  Reduced
recurrentgemma-2b (3 layers, window 32) with a 40-token prompt, past the
window so the ring-buffer cache has wrapped: prefill logits and every
cache entry against ``repro.models.rglru.prefill``, then eight greedy
decode steps against ``decode_step``.  The same for reduced smollm-135m
against ``transformer.prefill`` / ``decode_step``.

Tolerances: logits and f32 caches to 1e-4 (both sides compute in f32;
the reference scans associatively and attends blockwise, the port scans
sequentially and attends in one block, so only the order of sums
differs); the lm's bf16 KV cache to one bf16 rounding (the f32 keys
before the cast differ in their last bits, which may round either way);
greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jG
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import serve
from repro_torch.models import rglru as tG
from repro_torch.models import transformer as tT

PROMPT, STEPS, BATCH = 40, 8, 2
TOL = 1e-4
BF16_RTOL = 2.0 ** -7        # one bf16 rounding of either side


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


def _setup(arch, init):
    jcfg = jconfigs.get(arch).reduced()
    tcfg = tconfigs.get(arch).reduced()
    jparams, _ = init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = np.random.RandomState(3).randint(0, jcfg.vocab,
                                               (BATCH, PROMPT))
    return jcfg, tcfg, jparams, tparams, prompts


def _decode_both(jdecode, tdecode, jcache, tcache, jlog, tlog, vocab):
    """Eight greedy steps on both sides, each side fed its own tokens;
    returns the per-step logits and tokens."""
    steps = []
    for i in range(STEPS):
        jtok = jnp.argmax(jlog[..., :vocab], axis=-1)[:, None]
        ttok = tlog[..., :vocab].argmax(-1)[:, None]
        steps.append((jlog, tlog, np.asarray(jtok), ttok.numpy()))
        jlog, jcache = jdecode(jcache, jtok, jnp.int32(PROMPT + i))
        tlog, tcache = tdecode(tcache, ttok, PROMPT + i)
    steps.append((jlog, tlog, None, None))
    return steps, jcache, tcache


@pytest.fixture(scope="module")
def rg():
    jcfg, tcfg, jparams, tparams, prompts = _setup("recurrentgemma-2b",
                                                   jG.init_rglru_model)
    jlog, jcache = jG.prefill(jcfg, jparams, jnp.asarray(prompts))
    with torch.inference_mode():
        tlog, tcache = tG.prefill(tcfg, tparams, torch.from_numpy(prompts))
        pre = (jlog, tlog, jax.tree.map(np.asarray, jcache),
               {k: v.clone() for k, v in tcache.items()})
        jdec = jax.jit(lambda c, t, n: jG.decode_step(jcfg, jparams, c, t, n))
        steps, jend, tend = _decode_both(
            jdec, lambda c, t, n: tG.decode_step(tcfg, tparams, c, t, n),
            jcache, tcache, jlog, tlog, jcfg.vocab)
    return jcfg, tcfg, jparams, tparams, prompts, pre, steps, jend, tend


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg, jparams, tparams, prompts = _setup("smollm-135m", jT.init_lm)
    max_len = PROMPT + STEPS + 1
    jlog, jcache = jT.prefill(jcfg, jparams, jnp.asarray(prompts), max_len)
    with torch.inference_mode():
        tlog, tcache = tT.prefill(tcfg, tparams, torch.from_numpy(prompts),
                                  max_len)
        pre = (jlog, tlog, [np.asarray(c) for c in jcache],
               [c.clone() for c in tcache])
        jdec = jax.jit(lambda c, t, n: jT.decode_step(jcfg, jparams, c, t, n))
        steps, jend, tend = _decode_both(
            jdec, lambda c, t, n: tT.decode_step(tcfg, tparams, c, t, n),
            jcache, tcache, jlog, tlog, jcfg.vocab)
    return jcfg, tcfg, jparams, tparams, prompts, pre, steps, jend, tend


def test_reduced_recurrentgemma_config_matches_reference():
    j = jconfigs.get("recurrentgemma-2b").reduced()
    t = tconfigs.get("recurrentgemma-2b").reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim_",
              "lru_width", "window", "d_ff", "vocab", "vocab_padded",
              "pattern", "conv_width", "mlp_kind", "act_dtype_name"):
        assert getattr(j, f) == getattr(t, f), f
    assert PROMPT > t.window            # the ring buffer wraps


def test_rglru_prefill_logits_match_reference(rg):
    *_, pre, _, _, _ = rg
    jlog, tlog, _, _ = pre
    assert tlog.shape == jlog.shape and _close(jlog, tlog)


@pytest.mark.parametrize("key", ["kv_k", "kv_v", "state", "conv", "kv_pos"])
def test_rglru_prefill_cache_matches_reference(rg, key):
    *_, pre, _, _, _ = rg
    jc, tc = pre[2][key], pre[3][key]
    assert tuple(tc.shape) == jc.shape
    assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
    if key == "kv_pos":
        assert np.array_equal(tc.numpy(), jc)
    else:
        assert _close(jc, tc)


def test_rglru_decode_matches_reference(rg):
    *_, steps, jend, tend = rg
    for jlog, tlog, jtok, ttok in steps:
        assert _close(jlog, tlog)
        if jtok is not None:
            assert np.array_equal(jtok, ttok)
    for key in ("kv_k", "kv_v", "state", "conv"):
        assert _close(jend[key], tend[key]), key
    assert np.array_equal(np.asarray(jend["kv_pos"]), tend["kv_pos"].numpy())


def test_rglru_prefill_logits_at_every_position_match_reference(rg):
    """A forward with ``collect`` is a prefill (as the reference's); its
    logits hold at every position, before and past the window."""
    jcfg, tcfg, jparams, tparams, prompts, *_ = rg
    jlog, _ = jG.forward(jcfg, jparams, jnp.asarray(prompts), collect=True)
    with torch.inference_mode():
        tlog, caches = tG.forward(tcfg, tparams, torch.from_numpy(prompts),
                                  collect=True)
    assert tlog.shape == jlog.shape == (BATCH, PROMPT, tcfg.vocab_padded)
    assert set(caches) == {"kv_k", "kv_v", "state", "conv", "kv_pos"}
    assert _close(jlog, tlog)


def test_lm_prefill_matches_reference(lm):
    *_, pre, _, _, _ = lm
    jlog, tlog, jcache, tcache = pre
    assert _close(jlog, tlog)
    for jc, tc in zip(jcache, tcache):
        assert tuple(tc.shape) == jc.shape and tc.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=BF16_RTOL,
                                   atol=1e-6)


def test_lm_decode_matches_reference(lm):
    *_, steps, jend, tend = lm
    for jlog, tlog, jtok, ttok in steps:
        assert _close(jlog, tlog)
        if jtok is not None:
            assert np.array_equal(jtok, ttok)
    for jc, tc in zip(jend, tend):
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=BF16_RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-135m",
                                  "rwkv6-7b", "qwen2-7b", "qwen3-8b",
                                  "mistral-nemo-12b", "olmoe-1b-7b",
                                  "qwen2-moe-a2.7b"])
def test_serve_entry_point_on_cpu(arch):
    res = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                      "--prompt-len", "36", "--gen", "4", "--device", "cpu"])
    assert res.tokens.shape == (2, 4)
    assert bool(torch.isfinite(res.last_logits).all())
    assert res.prefill_seconds > 0 and res.decode_tokens_per_s > 0


def test_serve_refuses_encoder_decoder_and_vlm():
    """As the reference's serve: decoder-only archs, a SystemExit."""
    for arch, family in (("seamless-m4t-large-v2", "encdec"),
                         ("internvl2-2b", "vlm")):
        assert tconfigs.get(arch).family == family
        with pytest.raises(SystemExit, match=f"decoder-only archs, not "
                                             f"{family}"):
            serve.main(["--arch", arch, "--reduced", "--batch", "1",
                        "--prompt-len", "8", "--gen", "2", "--device",
                        "cpu"])


def test_convert_round_trip_on_the_rglru_tree(rg):
    _, tcfg, jparams, tparams, *_ = rg
    back = params_to_jax(tparams)
    jl, jt = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    bl, bt = jax.tree.flatten(back)
    assert jt == bt
    assert all(np.array_equal(a, b) for a, b in zip(jl, bl))
    # the port's own init has the reference's tree, shapes and dtypes
    own = params_to_jax(tG.init_rglru_model(tcfg,
                                            torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == jt
    assert all(a.shape == b.shape and a.dtype == b.dtype == np.float32
               for a, b in zip(jax.tree.leaves(own), jl))
