"""``--sync gspmd`` over a ``DeviceMesh`` for the recurrent families and the
MoE: 4 gloo ranks on a (2, 2) data x model mesh, the parameters DTensors
placed by the reference's logical-axis rules (tensor-parallel over
``model``, FSDP over ``data``), as ``test_torch_gspmd_pg.py`` runs the
``lm`` family.

Reduced rwkv6-7b (the chunked WKV on each rank's rows), recurrentgemma-2b
(the cache-free training forward: the associative RG-LRU scan and the
blockwise ``sdpa``, two query blocks of 64 over a window of 32) and
olmoe-1b-7b take two steps of 16 x 128 tokens from the reference's key-0
parameters, held to the reference's jitted gspmd step with
``tree_shardings`` in-shardings on a 4-device Auto mesh (one subprocess)
within ``test_torch_gspmd_pg.py``'s limits: loss and xent 1e-5, grad norm
1e-5 relative, and the first step's parameters within 2 lr + 1e-6 with
under 1e-3 of them beyond 1e-6.  The MoE's ``moe_load_balance`` and
``moe_router_z`` are held to the reference's each step within 1e-5
relative.  Every rank's local shard of every parameter has the shape
``spec_for`` names, every rank ends with the same parameters, and
``train.main --arch recurrentgemma-2b --mesh 2,2 --sync gspmd`` runs
under torchrun's environment.  Each spawned rank and the subprocess have
their own timeout, so a hang fails the test instead of stalling the
suite.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.dist import sharding as shd
from repro_torch.dist.steps import full_values, make_train_step
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

WORLD, MESH, NAMES = 4, (2, 2), ("data", "model")
ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "olmoe-1b-7b")
BATCH, SEQ, STEPS = 16, 128, 2
JOIN_S = 300
AUX = ("moe_load_balance", "moe_router_z")
MAIN = ["--arch", "recurrentgemma-2b", "--reduced", "--steps", "2",
        "--batch", "16", "--seq", "64", "--device", "cpu", "--log-every",
        "1", "--mesh", "2,2", "--sync", "gspmd"]

REF_CODE = r"""
import numpy as np
import jax
from jax.flatten_util import ravel_pytree
from jax.sharding import AxisType
from repro import configs
from repro.dist import sharding as shd
from repro.dist.steps import make_train_step
from repro.models.api import build
from repro.optim import AdamW, cosine_schedule
from repro.optim.adamw import OptState

mesh = jax.make_mesh((2, 2), ('data', 'model'),
                     axis_types=(AxisType.Auto,) * 2)
opt = AdamW(cosine_schedule(3e-4, 20, 100))
for arch in ARCHS:
    api = build(configs.get(arch).reduced())
    params, axes = api.init(jax.random.PRNGKey(0))
    tokens = np.load(OUT + arch + '.in.npy')
    pshard = shd.tree_shardings(axes, params, mesh, fsdp=True)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    bshard = {'tokens': jax.sharding.NamedSharding(
        mesh, shd.spec_for(('batch', None), tokens.shape[1:], mesh,
                           fsdp=False))}
    step = jax.jit(make_train_step(api, opt, mesh, mode='gspmd'),
                   in_shardings=(pshard, OptState(rep, pshard, pshard),
                                 bshard))
    out = {'params': np.asarray(ravel_pytree(params)[0])}
    state = opt.init(params)
    for i in range(STEPS):
        params, state, met = step(params, state,
                                  {'tokens': tokens[i]})
        if i == 0:
            out['first'] = np.asarray(ravel_pytree(params)[0])
        for k, v in met.items():
            out[f'{i}/{k}'] = np.asarray(v)
    np.savez(OUT + arch + '.npz', **out)
"""


def _tokens(arch):
    vocab = configs.get(arch).reduced().vocab
    return np.random.RandomState(11).randint(
        0, vocab, (STEPS, BATCH, SEQ + 1)).astype(np.int32)


def _flat(tree) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1)
                      for p in tree_leaves(tree)]).numpy()


def _ref_params(arch):
    import jax
    from repro import configs as jconfigs
    from repro.models import api as japi
    jp, _ = japi.build(jconfigs.get(arch).reduced()).init(
        jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, jp))


def _rank_main(rank, world, init, out_dir, ref_params):
    """One gloo rank: each arch's two steps from the reference's params
    (metrics, full params, local shard shapes) and train.main's
    recurrentgemma-2b gspmd run, saved to ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(MESH, NAMES)
        opt = AdamW(cosine_schedule(3e-4, 20, 100))
        out = {}
        for arch in ARCHS:
            api = build(configs.get(arch).reduced())
            sh = shd.tree_shardings(api.param_axes(), ref_params[arch], mesh,
                                    fsdp=True)
            params = shd.distribute(ref_params[arch], sh)
            state = opt.init(params)
            out[arch, "local"] = shd.map_axes(
                lambda a, p, s: (tuple(p.to_local().shape),
                                 shd.local_shape(s.spec, p.shape, mesh)),
                api.param_axes(), params, sh)
            step = make_train_step(api, opt, MESH, NAMES, mode="gspmd",
                                   group=dist.group.WORLD)
            tokens = _tokens(arch)
            for i in range(STEPS):
                params, state, met = step(
                    params, state,
                    {"tokens": torch.as_tensor(tokens[i], dtype=torch.long)})
                out[arch, i] = {k: float(v) for k, v in met.items()}
                if i == 0:
                    out[arch, "first"] = _flat(full_values(params))
            out[arch, "params"] = _flat(full_values(params))
            out[arch, "placed"] = all(
                p.placements == s.placements for p, s in zip(
                    tree_leaves(params), tree_leaves(sh)))
        res = train.main(MAIN)
        out["main"] = {"losses": res.losses, "params": _flat(res.params)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd_families_pg")
    ref = {arch: _ref_params(arch) for arch in ARCHS}
    ctx = mp.get_context("spawn")
    init = f"file://{tmp / 'store'}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, init, str(tmp), ref))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gspmd_families_ref") / "ref-")
    for arch in ARCHS:
        np.save(out + arch + ".in.npy", _tokens(arch))
    subproc(f"OUT = {out!r}\nARCHS = {ARCHS!r}\nSTEPS = {STEPS}\n"
            + REF_CODE, 4, timeout=300)
    return {arch: dict(np.load(out + arch + ".npz")) for arch in ARCHS}


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference(ranks, reference, arch, step):
    ref = reference[arch]
    assert np.array_equal(_flat(_ref_params(arch)), ref["params"])
    for r in ranks:
        met = r[arch, step]
        assert set(met) == {k.split("/", 1)[1] for k in ref
                            if k.startswith(f"{step}/")}
        g = float(ref[f"{step}/grad_norm"])
        assert abs(met["loss"] - float(ref[f"{step}/loss"])) < 1e-5
        assert abs(met["xent"] - float(ref[f"{step}/xent"])) < 1e-5
        assert abs(met["grad_norm"] - g) < 1e-5 * g
        assert met["lr"] == pytest.approx(float(ref[f"{step}/lr"]))
        for k in AUX:
            if k in met:
                want = float(ref[f"{step}/{k}"])
                assert abs(met[k] - want) <= 1e-5 * abs(want), (k, met[k])
        if step == 0:
            diff = np.abs(r[arch, "first"] - ref["first"])
            lr = float(ref["0/lr"])
            assert np.max(diff) <= 2 * lr + 1e-6
            assert np.mean(diff > 1e-6) < 1e-3


def test_moe_reports_its_aux_losses_each_step(ranks):
    for r in ranks:
        for i in range(STEPS):
            assert set(AUX) <= set(r["olmoe-1b-7b", i])
            assert all(np.isfinite(r["olmoe-1b-7b", i][k]) for k in AUX)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_as_spec_for_names(ranks, arch):
    """Every rank's local shard of every parameter has the shape
    ``spec_for`` names, and the step hands the parameters back in their
    placements."""
    for r in ranks:
        pairs = _leaves(r[arch, "local"])
        assert all(got == want for got, want in pairs), pairs
        assert r[arch, "placed"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS + ("main",))
def test_every_rank_ends_equal(ranks, arch):
    key = (arch, "params") if arch != "main" else "main"
    first = ranks[0][key]
    first = first["params"] if arch == "main" else first
    for r in ranks[1:]:
        got = r[key]["params"] if arch == "main" else r[key]
        assert np.array_equal(got, first)
    if arch == "main":
        losses = [r["main"]["losses"] for r in ranks]
        assert all(v == losses[0] for v in losses)
        assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
