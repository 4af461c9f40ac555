"""The port's ZeRO-1 against the reference's.

``ShardedAdamW.update_stripes`` is held against the reference's on the
same stripes, step for step, through the clip; ``decay_mask`` and the
owner-stripe cut of one replicated vector against ``stripe_slices``.
The zero1 train step runs side by side with the reference's zero1 step
(``shard_map`` on 16 fake host devices, one subprocess for the module,
meshes with Auto axes) on the reference's own toy problem (its
``tests/test_zero1_jax.py``: a quadratic loss over ``{"w": (6, 8), "b":
(5,)}``, 53 elements on 16 vertices): f32 for 5 steps, the f32 run
through the fault runtime with a link of tree 0 killed after 3 steps
(flip to the degraded class, ``reshard_owned`` of mu and nu, 3 more
steps), the int8 gradient wire (``codec="full"``, 1e-3 / 1e-2) and
``m = 7 < n = 16``; each step's loss within 1e-5 and grad norm within
1e-4 of the reference's (its own tolerances), the params and moments
within 1e-6.  Within the port, zero1 tracks ``psum_dp`` (toy and reduced
``smollm-135m``), and after every entry has run once a flip builds no
``striped_tables`` binding and no fabric index tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import ShardedAdamW as JShardedAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.optim.sharded import decay_mask as j_decay_mask
from repro_torch import configs as tconfigs
from repro_torch.core.collectives import striped_tables
from repro_torch.core.fault import FailureEvent
from repro_torch.dist.fabric import StackedFabric
from repro_torch.dist.steps import (edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.dist.striped import owner_stripes, stripe_slices
from repro_torch.models.api import build
from repro_torch.models.transformer import init_lm
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.sharded import decay_mask


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")
STEPS = 5
# tag -> ((w shape, b shape), quantized): the reference's cases
PROBLEMS = {"plain": (((6, 8), (5,)), False), "q8": (((6, 8), (5,)), True),
            "small": (((2, 2), (3,)), False)}
TOL = {"plain": (1e-5, 1e-4), "q8": (1e-3, 1e-2), "small": (1e-5, 1e-4),
       "kill": (1e-5, 1e-4)}


def _inputs():
    d = {}
    for tag, (shapes, _) in PROBLEMS.items():
        r = np.random.RandomState(0)
        d[tag + "/w"] = (r.randn(*shapes[0]) * 0.3).astype(np.float32)
        d[tag + "/b"] = (r.randn(*shapes[1]) * 0.3).astype(np.float32)
        d[tag + "/x"] = r.randn(32, *shapes[0]).astype(np.float32)
        d[tag + "/x2"] = r.randn(32, *shapes[1]).astype(np.float32)
        d[tag + "/y"] = r.randn(32).astype(np.float32)
    return d


CODE = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import AxisType
from repro.core.fault import FailureEvent
from repro.dist.steps import (make_train_step, fault_runtime_for_mesh,
                              edst_spec_for_mesh)
from repro.optim import AdamW, cosine_schedule, ShardedAdamW

class QuadAPI:
    def loss_fn(self, params, batch):
        pred = (jnp.einsum("bij,ij->b", batch["x"], params["w"])
                + batch["x2"] @ params["b"])
        return jnp.mean((pred - batch["y"]) ** 2), {}

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")
mesh = jax.make_mesh(SHAPE, NAMES, axis_types=(AxisType.Auto,) * 3)
inp = dict(np.load(OUT + ".in.npz"))
out = {}
def problem(tag):
    params = {k: jnp.asarray(inp[tag + "/" + k]) for k in ("w", "b")}
    batch = {k: jnp.asarray(inp[tag + "/" + k]) for k in ("x", "x2", "y")}
    return params, batch
def record(tag, s, p, st, m):
    out[f"{tag}/{s}/loss"] = np.asarray(m["loss"])
    out[f"{tag}/{s}/grad_norm"] = np.asarray(m["grad_norm"])
    out[f"{tag}/{s}/params"] = np.asarray(ravel_pytree(p)[0])
    out[f"{tag}/{s}/mu"] = np.asarray(st.mu)
    out[f"{tag}/{s}/nu"] = np.asarray(st.nu)
opt = AdamW(cosine_schedule(1e-2, 2, 20))
api = QuadAPI()
spec = edst_spec_for_mesh(SHAPE, NAMES, engine="striped")
for tag, q in (("plain", False), ("q8", True), ("small", False)):
    params, batch = problem(tag)
    z = jax.jit(make_train_step(api, opt, mesh, mode="edst", zero1=True,
                                engine="striped", quantize=q,
                                codec="full" if q else None))
    st = ShardedAdamW(opt).init_for(params, spec, 16)
    p = params
    for s in range(STEPS):
        p, st, m = z(p, st, batch)
        record(tag, s, p, st, m)
params, batch = problem("plain")
rt = fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")
z = jax.jit(make_train_step(api, opt, mesh, mode="edst", zero1=True,
                            fault_runtime=rt))
st = ShardedAdamW(opt).init_for(params, rt, 16)
p = params
size = 53
for s in range(3):
    p, st, m = z(p, st, batch, jnp.int32(0))
    record("kill", s, p, st, m)
dead = next(iter(sorted(rt.entries[0].sched.trees[0].tree)))
rt2 = rt.on_failure(FailureEvent(links=frozenset({dead})), prefer="degraded")
out["kill/sid"] = np.asarray(rt2.active)
st = type(st)(st.step, rt.reshard_owned(st.mu, 0, rt2.active, size),
              rt.reshard_owned(st.nu, 0, rt2.active, size))
for s in range(3, 6):
    p, st, m = z(p, st, batch, jnp.int32(rt2.active))
    record("kill", s, p, st, m)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("zero1") / "ref"
    inp = _inputs()
    np.savez(str(path) + ".in.npz", **inp)
    subproc(f"OUT = {str(path)!r}\nSTEPS = {STEPS}\n" + CODE, 16)
    return inp, dict(np.load(str(path) + ".npz"))


def quad(params, batch):
    """The reference's QuadAPI loss."""
    pred = torch.einsum("bij,ij->b", batch["x"], params["w"]) \
        + batch["x2"] @ params["b"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def _opt():
    return AdamW(cosine_schedule(1e-2, 2, 20))


def _problem(inp, tag):
    params = {"w": torch.from_numpy(inp[tag + "/w"]),
              "b": torch.from_numpy(inp[tag + "/b"])}
    batch = {k: torch.from_numpy(inp[tag + "/" + k]) for k in ("x", "x2", "y")}
    return params, batch


def _flat(p):
    return torch.cat([t.reshape(-1) for t in tree_leaves(p)]).numpy()


def _check(ref, tag, s, p, st, m):
    rl = float(ref[f"{tag}/{s}/loss"])
    rg = float(ref[f"{tag}/{s}/grad_norm"])
    tl, tg = TOL[tag]
    assert abs(float(m["loss"]) - rl) <= tl * abs(rl), (tag, s)
    assert abs(float(m["grad_norm"]) - rg) <= tg * max(rg, 1e-9), (tag, s)
    assert np.max(np.abs(_flat(p) - ref[f"{tag}/{s}/params"])) <= 1e-6
    for k in ("mu", "nu"):
        got = getattr(st, k).numpy()
        assert got.shape == ref[f"{tag}/{s}/{k}"].shape
        assert np.max(np.abs(got - ref[f"{tag}/{s}/{k}"])) <= 1e-6, (tag, k)
    assert st.step == s + 1 and m["ag_replicas_equal"]


@pytest.mark.parametrize("tag", sorted(PROBLEMS))
def test_zero1_step_matches_reference(reference, tag):
    inp, ref = reference
    q = PROBLEMS[tag][1]
    params, batch = _problem(inp, tag)
    opt = _opt()
    step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                           engine="striped", quantize=q,
                           codec="full" if q else None, loss=quad,
                           telemetry=True)
    st = ShardedAdamW(opt).init_for(
        params, edst_spec_for_mesh(SHAPE, NAMES, engine="striped"), 16)
    losses = []
    for s in range(STEPS):
        params, st, m = step(params, st, batch)
        _check(ref, tag, s, params, st, m)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_zero1_link_kill_matches_reference(reference, monkeypatch):
    """The f32 run through the fault runtime: 3 healthy steps, a link of
    tree 0 killed (flip to the degraded class, mu / nu resharded), 3
    more.  Every entry runs once first, from a scratch copy; after that
    the flips build no stripe binding and no fabric index tensor."""
    inp, ref = reference
    params, batch = _problem(inp, "plain")
    opt = _opt()
    rt = fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")
    step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                           fault_runtime=rt, loss=quad, telemetry=True)
    sopt = ShardedAdamW(opt)
    for sid in range(len(rt.entries)):
        step(params, sopt.init_for(params, rt, 16), batch, sid)
    created = []
    perm = StackedFabric._perm

    def spy(self, p):
        if p not in self._perms:
            created.append(p)
        return perm(self, p)

    monkeypatch.setattr(StackedFabric, "_perm", spy)
    bound = striped_tables.cache_info().misses
    st = sopt.init_for(params, rt, 16)
    for s in range(3):
        params, st, m = step(params, st, batch, 0)
        _check(ref, "kill", s, params, st, m)
    dead = next(iter(sorted(rt.entries[0].sched.trees[0].tree)))
    rt2 = rt.on_failure(FailureEvent(links=frozenset({dead})),
                        prefer="degraded")
    assert rt2.active == int(ref["kill/sid"]) != 0
    mu = rt.reshard_owned(st.mu, 0, rt2.active, 53)
    assert torch.equal(rt.reshard_owned(mu, rt2.active, 0, 53), st.mu)
    st = type(st)(st.step, mu, rt.reshard_owned(st.nu, 0, rt2.active, 53))
    for s in range(3, 6):
        params, st, m = step(params, st, batch, rt2.active)
        _check(ref, "kill", s, params, st, m)
    assert striped_tables.cache_info().misses == bound
    assert created == []
    with pytest.raises(ValueError, match="sid-out-of-range"):
        step(params, st, batch, -1)


def test_zero1_tracks_psum_dp_within_the_port(reference):
    inp, _ = reference
    params, batch = _problem(inp, "plain")
    opt = _opt()
    z = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                        engine="striped", loss=quad)
    d = make_train_step(None, opt, SHAPE, NAMES, mode="psum_dp", loss=quad)
    zs = ShardedAdamW(opt).init_for(
        params, edst_spec_for_mesh(SHAPE, NAMES, engine="striped"), 16)
    ds = opt.init(params)
    zp = dp = params
    for s in range(STEPS):
        zp, zs, zm = z(zp, zs, batch)
        dp, ds, dm = d(dp, ds, batch)
        assert abs(float(zm["loss"]) - float(dm["loss"])) <= \
            1e-5 * abs(float(dm["loss"]))
        assert abs(float(zm["grad_norm"]) - float(dm["grad_norm"])) <= \
            1e-5 * float(dm["grad_norm"])
        assert np.max(np.abs(_flat(zp) - _flat(dp))) <= 1e-6


def test_zero1_model_step_matches_psum_dp():
    """One reduced smollm-135m step: zero1's parameter move within 1e-5
    of psum_dp's, relative to its size (the chip smoke's rule)."""
    cfg = tconfigs.get("smollm-135m").reduced()
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(
        np.random.RandomState(5).randint(0, 256, (16, 33)), dtype=torch.long)
    api = build(cfg)
    z = make_train_step(api, opt, SHAPE, NAMES, zero1=True, engine="striped",
                        telemetry=True)
    d = make_train_step(api, opt, SHAPE, NAMES, mode="psum_dp")
    spec = edst_spec_for_mesh(SHAPE, NAMES, engine="striped")
    p0 = torch.from_numpy(_flat(params))
    zp, zs, zm = z(params, ShardedAdamW(opt).init_for(params, spec, 16),
                   {"tokens": tokens})
    dp, _, dm = d(params, opt.init(params), {"tokens": tokens})
    dz = torch.from_numpy(_flat(zp)) - p0
    dd = torch.from_numpy(_flat(dp)) - p0
    assert float((dz - dd).norm() / dd.norm()) <= 1e-5
    assert abs(float(zm["grad_norm"]) - float(dm["grad_norm"])) <= \
        1e-5 * float(dm["grad_norm"])
    assert float(zm["loss"]) == float(dm["loss"]) and zm["ag_replicas_equal"]


def test_update_stripes_matches_reference():
    rng = np.random.RandomState(1)
    shape = (2, 37)
    jopt = JShardedAdamW(JAdamW(j_cosine(1e-2, 2, 10)))
    topt = ShardedAdamW(AdamW(cosine_schedule(1e-2, 2, 10)))
    p = rng.randn(*shape).astype(np.float32)
    decay = np.where(rng.rand(*shape) < 0.5, 0.1, 0.0).astype(np.float32)
    mu = np.zeros(shape, np.float32)
    nu = np.zeros(shape, np.float32)
    tp, tmu, tnu = (torch.from_numpy(a[None].copy()) for a in (p, mu, nu))
    for step in range(1, 5):
        g = rng.randn(*shape).astype(np.float32) * (30.0 if step == 3 else 1)
        gnorm = float(np.sqrt((g.astype(np.float64) ** 2).sum()))
        p, mu, nu, jlr = jopt.update_stripes(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(decay),
            jnp.asarray(mu), jnp.asarray(nu), jnp.int32(step),
            jnp.float32(gnorm))
        tp, tmu, tnu, tlr = topt.update_stripes(
            tp, torch.from_numpy(g[None]), torch.from_numpy(decay[None]),
            tmu, tnu, step, torch.tensor(gnorm, dtype=torch.float32))
        for a, b in ((p, tp), (mu, tmu), (nu, tnu)):
            assert np.max(np.abs(np.asarray(a) - b[0].numpy())) <= \
                1e-6 * max(1.0, float(np.abs(np.asarray(a)).max()))
        assert float(jlr) == pytest.approx(float(tlr))
    part = ShardedAdamW.partial_sumsq(torch.ones(3, 2, 4))
    assert part.tolist() == [8.0, 8.0, 8.0]


def test_decay_mask_matches_reference():
    cfg = tconfigs.get("smollm-135m").reduced()
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    want = np.asarray(j_decay_mask(
        jax.tree.map(jnp.asarray, _as_numpy(params)), 0.1))
    got = decay_mask(params, 0.1).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("dims,names", [((4, 4, 1), NAMES),
                                        ((16, 1), ("data", "model"))])
@pytest.mark.parametrize("size,fractions", [(53, None), (7, None),
                                            (1001, None), (1001, "uneven")])
def test_owner_stripes_equal_stripe_slices(dims, names, size, fractions):
    """The cut from one replicated vector equals ``stripe_slices`` of the
    vector expanded to n rows."""
    spec = edst_spec_for_mesh(dims, names, engine="striped")
    fr = None if fractions is None else \
        tuple(np.linspace(1, 2, spec.k) / np.linspace(1, 2, spec.k).sum())
    vec = torch.randn(size)
    want = stripe_slices(vec.expand(16, size), spec, StackedFabric(16, "cpu"),
                         fractions=fr)
    got = owner_stripes(vec, spec, fr)
    assert torch.equal(got, want)
    assert got.shape == (16, spec.k, striped_tables(spec, size, fr).smax)
