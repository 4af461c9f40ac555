"""The port's checkpoints against the reference's: the same on-disk format
(``step_%08d/arrays.npz`` + ``manifest.json``, ``shard_%05d.npz`` with
CRC32 checksums for ZeRO-1), so dense and sharded round trips hold array
for array, a checkpoint written by either package restores in the other,
a restore onto another element map (a degraded failure class's) equals
the reference's and ``reshard_owned`` of the saved moments, and a
corrupted shard raises the CRC error."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.optim import AdamW as JAdamW
from repro.optim import ShardedOptState as JShardedOptState
from repro.optim import cosine_schedule as j_cosine
from repro_torch import ckpt as tckpt
from repro_torch.core.collectives import owner_element_map
from repro_torch.dist.steps import fault_runtime_for_mesh
from repro_torch.optim import AdamW, ShardedOptState, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")


def _params(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(6, 8).astype(np.float32),
            "b": r.randn(5).astype(np.float32),
            "blk": {"a/b": r.randn(3, 2).astype(np.float32),
                    "c%d": r.randn(4).astype(np.float32)}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_equal(a, b):
    la = [np.asarray(x) for x in jax.tree.leaves(a)]
    lb = [x.numpy() for x in tree_leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _dense_state(params_np, step=3):
    r = np.random.RandomState(step)
    mu = jax.tree.map(lambda x: r.randn(*x.shape).astype(np.float32),
                      params_np)
    nu = jax.tree.map(lambda x: r.rand(*x.shape).astype(np.float32),
                      params_np)
    return step, mu, nu


def test_dense_round_trip(tmp_path):
    p = _torch(_params())
    step, mu, nu = _dense_state(_params())
    opt_state = AdamW(cosine_schedule(1e-3, 2, 10)).init(p)._replace(
        step=step, mu=_torch(mu), nu=_torch(nu))
    tckpt.save_checkpoint(str(tmp_path), 3, {"p": p, "o": opt_state})
    tmpl = {"p": _torch(_params(1)),
            "o": AdamW(cosine_schedule(1e-3, 2, 10)).init(p)}
    got, at, extra = tckpt.restore(str(tmp_path), tmpl)
    assert at == 3 and extra == {}
    assert got["o"].step == 3 and isinstance(got["o"].step, int)
    for a, b in zip(tree_leaves(got["p"]) + tree_leaves(got["o"].mu),
                    tree_leaves(p) + tree_leaves(opt_state.mu)):
        assert torch.equal(a, b)
    assert tckpt.restore(str(tmp_path / "none"), tmpl) == (None, None, None)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dense_checkpoints_cross_packages(tmp_path, writer):
    params = _params()
    step, mu, nu = _dense_state(params)
    jstate = JAdamW(j_cosine(1e-3, 2, 10)).init(_jax(params))._replace(
        step=jnp.int32(step), mu=_jax(mu), nu=_jax(nu))
    tstate = AdamW(cosine_schedule(1e-3, 2, 10)).init(_torch(params))._replace(
        step=step, mu=_torch(mu), nu=_torch(nu))
    if writer == "reference":
        jckpt.save_checkpoint(str(tmp_path), 7, {"p": _jax(params),
                                                 "o": jstate})
    else:
        tckpt.save_checkpoint(str(tmp_path), 7, {"p": _torch(params),
                                                 "o": tstate})
    other = _params(1)
    tgot, tat, _ = tckpt.restore(str(tmp_path), {
        "p": _torch(other),
        "o": AdamW(cosine_schedule(1e-3, 2, 10)).init(_torch(other))})
    jgot, jat, _ = jckpt.restore(str(tmp_path), {
        "p": _jax(other), "o": JAdamW(j_cosine(1e-3, 2, 10)).init(
            _jax(other))})
    assert tat == jat == 7
    _leaves_equal(jgot["p"], tgot["p"])
    _leaves_equal(jgot["o"].mu, tgot["o"].mu)
    _leaves_equal(jgot["o"].nu, tgot["o"].nu)
    assert int(jgot["o"].step) == tgot["o"].step == step
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert "o/0" in manifest["keys"] and "p/blk/a%2Fb" in manifest["keys"]
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as npz:
        assert npz["o/0"].dtype == np.int32


def _sharded(rt, size, sid=0, seed=0):
    """Moments laid out on entry ``sid``'s element map (zero padding)."""
    emap = rt.zero1_element_map(size, sid)
    r = np.random.RandomState(seed)
    mu = np.where(emap >= 0, r.randn(*emap.shape), 0).astype(np.float32)
    nu = np.where(emap >= 0, r.rand(*emap.shape), 0).astype(np.float32)
    return emap, mu, nu


@pytest.fixture(scope="module")
def runtime():
    return fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")


def test_sharded_round_trip_and_crc(tmp_path, runtime):
    params = _torch(_params())
    size = sum(p.numel() for p in tree_leaves(params))
    emap, mu, nu = _sharded(runtime, size)
    state = ShardedOptState(4, torch.from_numpy(mu), torch.from_numpy(nu))
    path = tckpt.save_sharded_checkpoint(str(tmp_path), 4, params, state,
                                         emap, size, extra={"k": 1})
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"] + \
        [f"shard_{v:05d}.npz" for v in range(16)]
    p2, st2, at, extra = tckpt.restore_sharded(str(tmp_path),
                                               _torch(_params(1)), emap)
    assert (at, extra, st2.step) == (4, {"k": 1}, 4)
    assert torch.equal(st2.mu, state.mu) and torch.equal(st2.nu, state.nu)
    for a, b in zip(tree_leaves(p2), tree_leaves(params)):
        assert torch.equal(a, b)
    # a byte flipped in one shard fails its manifest CRC32
    shard = os.path.join(path, "shard_00003.npz")
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC32"):
        tckpt.restore_sharded(str(tmp_path), params, emap)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("target", [0, 1, 3])
def test_sharded_checkpoints_cross_packages(tmp_path, runtime, writer,
                                            target):
    """Saved on the healthy entry's map, restored onto entry ``target``'s
    by both packages: equal to each other and to ``reshard_owned``."""
    params = _params()
    size = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    emap, mu, nu = _sharded(runtime, size)
    if writer == "reference":
        jckpt.save_sharded_checkpoint(
            str(tmp_path), 2, _jax(params),
            JShardedOptState(jnp.int32(2), jnp.asarray(mu), jnp.asarray(nu)),
            emap, size)
    else:
        tckpt.save_sharded_checkpoint(
            str(tmp_path), 2, _torch(params),
            ShardedOptState(2, torch.from_numpy(mu), torch.from_numpy(nu)),
            emap, size)
    tmap = runtime.zero1_element_map(size, target)
    tp, tst, tat, _ = tckpt.restore_sharded(str(tmp_path),
                                            _torch(_params(1)), tmap)
    jp, jst, jat, _ = jckpt.restore_sharded(str(tmp_path),
                                            _jax(_params(1)), tmap)
    assert tat == jat == 2 and tst.step == int(jst.step) == 2
    _leaves_equal(jp, tp)
    assert np.array_equal(np.asarray(jst.mu), tst.mu.numpy())
    assert np.array_equal(np.asarray(jst.nu), tst.nu.numpy())
    moved = runtime.reshard_owned(torch.from_numpy(mu), 0, target, size)
    assert torch.equal(tst.mu, moved)


def test_sharded_restore_onto_another_fabric(tmp_path):
    """Saved on the 4x4 torus, restored onto the ring 16's map."""
    params = _torch(_params())
    size = sum(p.numel() for p in tree_leaves(params))
    rt = fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")
    emap, mu, nu = _sharded(rt, size)
    tckpt.save_sharded_checkpoint(
        str(tmp_path), 1, params,
        ShardedOptState(1, torch.from_numpy(mu), torch.from_numpy(nu)),
        emap, size)
    from repro_torch.dist.steps import edst_spec_for_mesh
    ring = owner_element_map(
        edst_spec_for_mesh((16, 1), ("data", "model"), engine="striped"),
        size)
    _, st, _, _ = tckpt.restore_sharded(str(tmp_path), params, ring)
    flat = np.zeros(size, np.float32)
    flat[emap[emap >= 0]] = mu[emap >= 0]
    want = np.where(ring >= 0, flat[np.clip(ring, 0, None)], 0)
    assert np.array_equal(st.mu.numpy(), want)
