"""The reference's blockwise attention and associative RG-LRU scan in the
port, against the reference on the CPU, and the recurrentgemma training
forward that builds no cache.

``layers.sdpa`` against the reference's ``layers.sdpa`` at (q_block,
kv_block) in {(64, 64), (64, 32), (32, 64)}: causal with and without a
window at S a multiple (128) and not a multiple (100) of the blocks, the
full mask, a 5-query step into a linear cache (``valid_len``), a ring
cache's ``kv_pos`` with sentinels, and a one-query decode over T = 200;
outputs and the gradients of q, k and v (``jax.vjp`` against autograd,
one seeded cotangent), in f32 and bf16, within
``test_torch_model.py::test_sdpa_matches_reference``'s tolerances: 1e-5
in f32 and 2e-2 in bf16, the gradients (up to about 6.6 here) held to
those times their largest reference value, where a bf16 gradient sits one
rounding (2^-8 of its value) from the reference's.  The causal case over
S == T computes only the reference's blocks (the rows of its batched
products counted against the triangle).

``rglru.rg_lru_scan`` against the reference's ``rg_lru_scan`` with and
without ``h0`` at S in {1, 7, 64, 257}: outputs to 1e-6 and gradients
to 1e-5.  recurrentgemma-2b's ``loss_fn`` builds no cache (no ring buffer
is written; ``forward`` hands back ``None``), and ``prefill`` builds the
caches the kernel path built before: each equal to a ring filled from the
collect pass's keys and the scans' last states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro.models import rglru as jG
from repro_torch import configs as tconfigs
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.models import rglru as tG

BLOCKS = [(64, 64), (64, 32), (32, 64)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
H, KV, D = 4, 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases():
    """name -> (S, T, mask_mode, window, valid_len, q_pos, kv_pos)."""
    out = {}
    for s in (128, 100):
        p = np.arange(s, dtype=np.int32)
        out[f"causal{s}"] = (s, s, "causal", None, None, p, p)
        out[f"window{s}"] = (s, s, "causal", 40, None, p, p)
        out[f"full{s}"] = (s, s, "full", None, None, p, p)
    out["valid_len"] = (5, 200, "causal", None, 150,
                        np.arange(145, 150, dtype=np.int32),
                        np.arange(200, dtype=np.int32))
    ring = np.full(48, 10 ** 9, np.int32)      # slot = position % 48
    ring[np.arange(60, 100) % 48] = np.arange(60, 100)
    out["ring"] = (1, 48, "causal", 40, None, np.array([99], np.int32), ring)
    out["decode"] = (1, 200, "causal", None, 200,
                     np.array([199], np.int32),
                     np.arange(200, dtype=np.int32))
    return out


CASES = _cases()


def _sdpa_pair(name, qb, kb, dtype):
    s, t, mode, window, valid, qpos, kvpos = CASES[name]
    rng = np.random.RandomState(s * 7 + t)
    q = rng.randn(2, s, H, D).astype(np.float32)
    k, v = (rng.randn(2, t, KV, D).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, s, H, D).astype(np.float32)
    jcfg = jL.AttnCfg(d_model=H * D, n_heads=H, n_kv=KV, head_dim=D,
                      window=window)
    tcfg = tL.AttnCfg(d_model=H * D, n_heads=H, n_kv=KV, head_dim=D,
                      window=window)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def jfn(a, b, c):
        return jL.sdpa(a, b, c, jnp.asarray(qpos), jnp.asarray(kvpos), jcfg,
                       mode, valid_len=valid, q_block=qb, kv_block=kb)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x).astype(jdt)
                               for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(cot).astype(jdt))
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(True)
          for x in (q, k, v)]
    tout = tL.sdpa(*ts, torch.from_numpy(qpos), torch.from_numpy(kvpos),
                   tcfg, mode, valid_len=valid, q_block=qb, kv_block=kb)
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(cot).to(tdt))
    return (jout, jgrads), (tout, tgrads)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qb,kb", BLOCKS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sdpa_matches_reference(name, qb, kb, dtype):
    (jout, jgrads), (tout, tgrads) = _sdpa_pair(name, qb, kb, dtype)
    tol = TOL[dtype]
    assert tout.shape == jout.shape and tout.dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert np.max(np.abs(_f32(jout) - _f32(tout))) < tol
    for jg, tg in zip(jgrads, tgrads):
        want = _f32(jg)
        scale = max(1.0, float(np.max(np.abs(want))))
        assert np.max(np.abs(want - _f32(tg))) < tol * scale


@pytest.mark.parametrize("qb,kb", BLOCKS)
@pytest.mark.parametrize("s", [128, 100])
def test_causal_blocks_are_the_references(qb, kb, s, monkeypatch):
    """The logits products a causal S == T call computes: the reference's
    triangle of (q_block x kv_block) blocks, query block i over key blocks
    [0, ceil((i+1) qb / kb)), whatever the grouping of a step."""
    rows = []
    real = torch.bmm

    def counted(x, y):
        rows.append(x.shape[1])
        return real(x, y)

    monkeypatch.setattr(torch, "bmm", counted)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, s, n, D).astype(np.float32))
               for n in (H, KV, KV))
    pos = torch.arange(s)
    with torch.no_grad():
        tL.sdpa(q, k, v, pos, pos, tL.AttnCfg(H * D, H, KV, D),
                q_block=qb, kv_block=kb)
    nq, nk = -(-s // qb), -(-s // kb)
    want = sum(min(nk, -(-((i + 1) * qb) // kb)) for i in range(nq))
    # two products a block (q k^T, p v), each of (H / KV) x q_block rows
    assert sum(rows) == 2 * want * (H // KV) * qb
    assert want < nq * nk


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64, 257])
def test_rg_lru_scan_matches_reference(s, with_h0):
    rng = np.random.RandomState(s)
    a = (1.0 / (1.0 + np.exp(-rng.randn(2, s, 16)))).astype(np.float32)
    bx = rng.randn(2, s, 16).astype(np.float32)
    h0 = rng.randn(2, 16).astype(np.float32) if with_h0 else None
    cot = rng.randn(2, s, 16).astype(np.float32)

    def jfn(a_, b_, *h):
        return jG.rg_lru_scan(a_, b_, h[0] if h else None)

    jargs = [jnp.asarray(x) for x in (a, bx) + ((h0,) if with_h0 else ())]
    jout, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(x).requires_grad_(True)
             for x in (a, bx) + ((h0,) if with_h0 else ())]
    tout = tG.rg_lru_scan(targs[0], targs[1],
                          targs[2] if with_h0 else None)
    tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(cot),
                                 allow_unused=True, materialize_grads=True)
    assert tout.shape == (2, s, 16)
    assert np.max(np.abs(np.asarray(jout) - tout.detach().numpy())) < 1e-6
    for jg, tg in zip(jgrads, tgrads):
        assert np.max(np.abs(np.asarray(jg) - tg.numpy())) < 1e-5
    # the same function as the kernel's sequential plain version
    seq, last = rglru_ref(targs[0].detach(), targs[1].detach(),
                          targs[2].detach() if with_h0 else None)
    assert torch.allclose(tout.detach(), seq, atol=1e-6)
    assert torch.allclose(tout.detach()[:, -1], last, atol=1e-6)


@pytest.fixture(scope="module")
def rg():
    cfg = tconfigs.get("recurrentgemma-2b").reduced()
    api = tapi.build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.RandomState(3).randint(
        0, cfg.vocab, (2, 41)), dtype=torch.long)
    return cfg, api, params, tokens


def test_rglru_loss_builds_no_cache(rg, monkeypatch):
    cfg, api, params, tokens = rg
    rings = []
    real = tG._ring
    monkeypatch.setattr(tG, "_ring", lambda *a: rings.append(1) or real(*a))
    loss, _ = api.loss_fn(params, {"tokens": tokens})
    assert torch.isfinite(loss) and rings == []
    _, caches = tG.forward(cfg, params, tokens[:, :-1], return_hidden=True)
    assert caches is None and rings == []
    with torch.no_grad():
        api.prefill_fn(params, {"tokens": tokens})
    assert len(rings) == 2 * sum(k == "attn" for k in tG._layer_kinds(cfg))


def test_rglru_prefill_builds_the_caches(rg):
    """``prefill`` (collect) builds each cache as the kernel path built it:
    the ring of the last ``window`` keys (slot = position % window), the
    scans' last states, the conv tails and ``kv_pos``; its logits are
    those of the cache-free forward at the last position."""
    cfg, api, params, tokens = rg
    prompt = tokens[:, :40]
    with torch.no_grad():
        logits, caches = tG.prefill(cfg, params, prompt)
        hidden, none = tG.forward(cfg, params, prompt)
    assert none is None
    assert torch.allclose(logits, hidden[:, -1], atol=1e-5)
    kinds = tG._layer_kinds(cfg)
    n_rec = sum(k == "rec" for k in kinds)
    n_att = sum(k == "attn" for k in kinds)
    wnd = cfg.window
    assert set(caches) == {"kv_k", "kv_v", "state", "conv", "kv_pos"}
    assert caches["kv_k"].shape == (n_att, 2, wnd, cfg.n_kv, cfg.head_dim_)
    assert caches["state"].shape == (n_rec, 2, cfg.lru_width)
    assert caches["state"].dtype == torch.float32
    assert caches["conv"].shape == (n_rec, 2, cfg.conv_width - 1,
                                    cfg.lru_width)
    pos = np.arange(40)[-wnd:]
    want = np.full(wnd, 10 ** 9, np.int32)
    want[pos % wnd] = pos
    assert np.array_equal(caches["kv_pos"].numpy(), want)
    # a decode step from these caches equals the cache-free forward's next
    # position
    with torch.no_grad():
        step, _ = tG.decode_step(cfg, params, caches, tokens[:, 40:41], 40)
        full, _ = tG.forward(cfg, params, tokens[:, :41])
    assert torch.allclose(step, full[:, -1], atol=1e-4)
