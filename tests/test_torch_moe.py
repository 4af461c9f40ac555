"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe.moe_layer`` on the CPU in f32.

Both sides take the same seeded numpy weights and activations.  The
reference's own top-k (its ``gate_idx``) is read by wrapping
``jax.lax.top_k`` while it runs, and the port's routing must pick the
same experts, exactly, before its output is compared.  Cases: S a
multiple of the group, S = 33 over groups of 32 (the zero-padded last
group, whose padding tokens tie on every expert), padded experts (6 real
of 8, masked to -1e30), shared experts on and off, renorm on and off,
S = 1 (decode), and a capacity factor under which the reference itself
drops (token, choice) pairs past an expert's capacity.

Tolerances: the output within 1e-5 and both aux losses within 1e-6 of
max(1, |loss|) (f32 on both sides; only the order of sums differs).  The
router-z loss is a mean of squared log-sum-exps near 10 here, where one
f32 ulp is 9.5e-7 and two f32 means of the same values summed in another
order differ by several ulps, so the limit is relative above 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jM
from repro_torch.models import moe as tM

OUT_TOL, AUX_TOL = 1e-5, 1e-6
BASE = dict(d_model=64, n_experts=8, n_experts_padded=8, top_k=2,
            d_expert=48, n_shared=0, group_size=32, capacity_factor=1.0,
            renorm=True)
# (name, config overrides, batch, seq)
CASES = [
    ("s_multiple_of_g", {}, 2, 64),
    ("s33_padded_group", {}, 2, 33),
    ("padded_experts", {"n_experts": 6}, 2, 64),
    ("shared_experts", {"n_shared": 2}, 2, 64),
    ("shared_padded_s33", {"n_shared": 1, "n_experts": 6}, 2, 33),
    ("no_renorm", {"renorm": False}, 2, 64),
    ("no_renorm_top3", {"renorm": False, "top_k": 3}, 2, 40),
    ("decode_s1", {"n_shared": 1}, 3, 1),
    ("capacity_drops", {"capacity_factor": 0.5}, 2, 64),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(cfg, seed):
    rng = np.random.RandomState(seed)
    e, d, f = cfg["n_experts_padded"], cfg["d_model"], cfg["d_expert"]

    def n(*shape, scale=None):
        scale = 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[0]) \
            if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"router": n(d, e, scale=0.3), "wi_gate": n(e, d, f),
         "wi_up": n(e, d, f), "wo": n(e, f, d)}
    if cfg["n_shared"]:
        fs = cfg["n_shared"] * f
        p["shared"] = {"wi_gate": n(d, fs), "wi_up": n(d, fs),
                       "wo": n(fs, d), "gate": n(d, 1, scale=0.3)}
    return p


def _reference(p, cfg, x, monkeypatch):
    """The reference's output, aux losses and the gate_idx its top_k
    returned."""
    seen = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        seen.append(np.asarray(idx))
        return vals, idx

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", recording)
        out, aux = jM.moe_layer(jax.tree.map(jnp.asarray, p),
                                jM.MoECfg(**cfg), jnp.asarray(x))
    assert len(seen) == 1
    return np.asarray(out), {k: float(v) for k, v in aux.items()}, seen[0]


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _groups(x, g):
    """x (B, S, d) zero-padded to whole groups of g -> (B, NG, G, d)."""
    b, s, d = x.shape
    s_pad = -(-s // g) * g
    return torch.nn.functional.pad(x, (0, 0, 0, s_pad - s)).reshape(
        b, s_pad // g, g, d)


@pytest.mark.parametrize("name,over,b,s", CASES, ids=[c[0] for c in CASES])
def test_moe_layer_matches_reference(name, over, b, s, monkeypatch):
    cfg = {**BASE, **over}
    p = _weights(cfg, seed=len(name))
    x = np.random.RandomState(7).standard_normal(
        (b, s, cfg["d_model"])).astype(np.float32)
    jout, jaux, jidx = _reference(p, cfg, x, monkeypatch)

    tcfg = tM.MoECfg(**cfg)
    tp, tx = _tensors(p), torch.from_numpy(x)
    g = min(tcfg.group_size, s)
    _, _, _, tidx = tM.route(tp, tcfg, _groups(tx, g))
    assert tidx.shape == jidx.shape
    assert np.array_equal(tidx.numpy(), jidx)
    if cfg["n_experts"] != cfg["n_experts_padded"]:
        assert int(jidx.max()) < cfg["n_experts"]     # the mask held

    tout, taux = tM.moe_layer(tp, tcfg, tx)
    assert tout.shape == jout.shape == (b, s, cfg["d_model"])
    assert float(np.abs(tout.numpy() - jout).max()) < OUT_TOL
    assert set(taux) == set(jaux) == {"moe_load_balance", "moe_router_z"}
    for k in jaux:
        assert abs(float(taux[k]) - jaux[k]) < \
            AUX_TOL * max(1.0, abs(jaux[k])), k

    if name == "capacity_drops":
        # the reference's own routing sends some expert more (token,
        # choice) pairs in a group than it has slots
        per_expert = np.stack([(jidx == e).sum(axis=(2, 3))
                               for e in range(cfg["n_experts_padded"])])
        assert int(per_expert.max()) > tM.capacity(tcfg, g)


def test_capacity_is_the_reference_rule():
    """max(4, round_up_4(ceil(g k / n_experts * cf))) over the real
    experts: olmoe-1b-7b's 32 and qwen2-moe-a2.7b's 36 (60 real of 64)."""
    olmoe = tM.MoECfg(2048, 64, 64, 8, 1024, group_size=256)
    qmoe = tM.MoECfg(2048, 60, 64, 4, 1408, n_shared=4, group_size=512)
    assert tM.capacity(olmoe, 256) == 32
    assert tM.capacity(qmoe, 512) == 36
    assert tM.capacity(qmoe, 1) == 4
    assert tM.capacity(dataclasses.replace(qmoe, capacity_factor=0.01),
                       512) == 4
