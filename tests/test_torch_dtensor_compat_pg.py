"""The port's DTensor paths under what torch 2.11 refuses
(``_dtensor_guard.refusing_as_torch_2_11``), on 4 gloo ranks of a (2, 2)
data x model mesh.

The card's torch (2.11) stopped four sites of the models that this
sandbox's torch (2.13) runs: an ``add`` of a split bias to a product's
partial sum over ``model`` (recurrentgemma-2b's gate logits and its
convolution), a contraction that flattens the split experts behind the
capacity slots (the MoE's combine), a batched product that flattens the
split heads behind the split batch (rwkv6-7b's one-token WKV step), and
an indexed write (recurrentgemma-2b's ring buffer).  Under the guard, on
every rank:

* each site's former formulation raises as torch 2.11 does, and the
  port's runs;
* each repaired site is held to the plain function on the whole tensors:
  bit for bit where no rank adds what another holds (the WKV step's output
  and gradients but ``u``'s, the ring buffer), else within 1e-6 of the
  largest value (partial sums over ``model``, ``u``'s sum over the batch
  rows); the gate logits also bit for bit with the former
  formulation without the guard (torch 2.13 reduce-scatters the partial
  sum there by itself);
* one ``--sync gspmd --mesh 2,2`` step of each of the five reduced token
  families runs through ``train.main`` under torchrun's environment;
* the reduced recurrentgemma-2b ``train_4k`` dry-run cell (its own
  process, on the fake 16 x 16 group) exits 0.

And on one gloo rank, the gspmd step with DTensor parameters on a (1, 1)
mesh is bit for bit the stacked gspmd step (loss, grad norm, parameters)
for the five families: its gradients are made contiguous before the
clip's sum of squares, as the stacked step's rows hold them.  Each
spawned process has its own timeout, so a hang fails the test instead of
stalling the suite.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _dtensor_guard import refusing_as_torch_2_11
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.steps import full_values, make_train_step
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models.api import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

WORLD, MESH, NAMES = 4, (2, 2), ("data", "model")
ARCHS = ("smollm-135m", "qwen3-8b", "rwkv6-7b", "olmoe-1b-7b",
         "recurrentgemma-2b")
STEP = ["--reduced", "--steps", "1", "--batch", "16", "--seq", "16",
        "--device", "cpu", "--log-every", "1", "--mesh", "2,2", "--sync",
        "gspmd"]
SITES = ("gate logits", "moe combine", "wkv6 step", "ring buffer")
# the results (output, then each input's gradient) that no rank adds to
# what another holds, by site: bit for bit with the plain function
EXACT = {"wkv6 step": (0, 1, 2, 3, 4, 6),    # all but u's row sum
         "ring buffer": (0, 1)}
JOIN_S = 300
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")


def _inputs(site):
    rng = np.random.RandomState(7)

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    if site == "gate logits":                   # cf (B, S, W), w, bias
        return f(4, 8, 8), f(8, 8), f(8)
    if site == "moe combine":                   # combine, xout
        return f(4, 2, 6, 8, 4), f(4, 2, 8, 4, 16)
    if site == "wkv6 step":                     # r k v logw (B, H, N), u, s
        return (f(4, 4, 8), f(4, 4, 8), f(4, 4, 8),
                -torch.exp(f(4, 4, 8) * 0.5 - 3.0), f(4, 8) * 0.5,
                f(4, 4, 8, 8))
    return (f(4, 12, 2, 8),)                    # keys (B, S, KV, hd)


def _former(site, *xs):
    """The site as the port wrote it before torch 2.11 ran it."""
    if site == "gate logits":
        cf, w, bias = xs
        return torch.einsum("bsw,wv->bsv", cf, w.float()) + bias
    if site == "moe combine":
        return torch.einsum("bgtec,bgecd->bgtd", *xs)
    if site == "wkv6 step":
        r, k, v, logw, u, s = xs
        kv = torch.einsum("bhn,bhm->bhnm", k, v)
        return torch.einsum("bhn,bhnm->bhm", r, s + u[..., None] * kv)
    k, wnd = xs[0], 8
    positions = torch.arange(k.shape[1])
    buf = k.new_zeros((k.shape[0], wnd) + tuple(k.shape[2:]))
    buf[:, positions[-wnd:] % wnd] = k[:, -wnd:]
    return buf


def _repaired(site, *xs):
    if site == "gate logits":
        return rglru._gate_logits(*xs)
    if site == "moe combine":
        return moe.combine_experts(*xs)
    if site == "wkv6 step":
        return rwkv6.wkv6_step(*xs)[0]
    return rglru._ring(xs[0], torch.arange(xs[0].shape[1]), 8)


def _placements(site):
    """How a model hands each input over on the (data, model) mesh."""
    from torch.distributed.tensor import Replicate as R
    from torch.distributed.tensor import Shard as S
    return {"gate logits": [[S(0), S(2)], [R(), S(0)], [R(), S(0)]],
            "moe combine": [[S(0), S(3)], [S(0), S(2)]],
            "wkv6 step": [[S(0), S(1)]] * 4 + [[R(), S(0)],
                                                [S(0), S(1)]],
            "ring buffer": [[S(0), R()]]}[site]


def _run(site, fn, mesh=None):
    """``fn``'s output and the gradients of its inputs (whole values): on
    DTensors placed as a model hands them over where ``mesh`` is given,
    else on the plain whole tensors."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    xs = _inputs(site)
    if mesh is not None:
        xs = [distribute_tensor(x, mesh, pl)
              for x, pl in zip(xs, _placements(site))]
    xs = [x.requires_grad_(True) for x in xs]
    with implicit_replication():        # as the models run (a plain index)
        out = fn(site, *xs)
    ct = torch.from_numpy(np.random.RandomState(9).randn(
        *out.shape).astype(np.float32))
    if mesh is None:
        loss = (out * ct).sum()
    else:
        # each rank's own elements (a partial sum made whole) against the
        # cotangent's: the output's gradient arrives in those placements
        from torch.distributed.tensor import Replicate
        out = out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in out.placements])
        ct = distribute_tensor(ct, mesh, out.placements).to_local()
        loss = (out.to_local() * ct).sum()
    # (the WKV step's output does not depend on the decay)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    whole = (lambda t: t) if mesh is None else (lambda t: t.full_tensor())
    return [whole(out).detach()] + [None if g is None else whole(g)
                                    for g in grads]


def _refused(site, mesh) -> bool:
    try:
        _run(site, _former, mesh)
    except RuntimeError as e:
        return "refused as torch 2.11" in str(e)
    return False


def _rank_main(rank, world, init, out_dir):
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = {}
        # the guard before any DTensor op: DTensor caches propagations
        with refusing_as_torch_2_11():
            mesh = make_mesh(MESH, NAMES)
            for site in SITES:
                out[site] = {"refused": _refused(site, mesh),
                             "repaired": _run(site, _repaired, mesh)}
            for arch in ARCHS:
                out[arch] = train.main(["--arch", arch] + STEP).losses
        # torch 2.13's own placement of the gate logits' sum
        out["gate logits"]["former"] = _run("gate logits", _former, mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _world1_main(rank, world, init, out_dir):
    """The stacked gspmd step and the DTensor one on a (1, 1) mesh."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((1, 1), NAMES)
        opt = AdamW(cosine_schedule(3e-4, 20, 100))
        out = {}
        for arch in ARCHS:
            api = build(configs.get(arch).reduced())
            p0 = api.init(torch.Generator().manual_seed(0), "cpu")
            tokens = torch.from_numpy(np.random.RandomState(3).randint(
                0, api.cfg.vocab, (8, 33)))
            plain = make_train_step(api, opt, (1,), ("data",), mode="gspmd")
            pa, _, ma = plain(p0, opt.init(p0), {"tokens": tokens})
            pd = shd.distribute(p0, shd.tree_shardings(api.param_axes(), p0,
                                                       mesh))
            placed = make_train_step(api, opt, (1, 1), NAMES, mode="gspmd",
                                     group=dist.group.WORLD)
            pb, _, mb = placed(pd, opt.init(pd), {"tokens": tokens})
            out[arch] = [(float(m["loss"]), float(m["grad_norm"]),
                          torch.cat([p.reshape(-1) for p in tree_leaves(q)]))
                         for m, q in ((ma, pa), (mb, full_values(pb)))]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(target, world, tmp):
    ctx = mp.get_context("spawn")
    init = f"file://{tmp / 'store'}"
    procs = [ctx.Process(target=target, args=(r, world, init, str(tmp)))
             for r in range(world)]
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
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawn(_rank_main, WORLD, tmp_path_factory.mktemp("compat_pg"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _spawn(_world1_main, 1, tmp_path_factory.mktemp("compat_w1"))[0]


@pytest.mark.parametrize("site", SITES)
def test_the_former_site_is_refused_as_on_torch_2_11(ranks, site):
    for r in ranks:
        assert r[site]["refused"]


@pytest.mark.parametrize("site", SITES)
def test_repaired_site_matches_the_plain_function(ranks, site):
    torch.set_num_threads(1)
    want = _run(site, _repaired)
    former = _run(site, _former)
    for g, w in zip(want, former):      # the plain function is unchanged
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape
            assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    for r in ranks:
        got = r[site]["repaired"]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None)
            if w is None:
                continue
            assert g.shape == w.shape
            if i in EXACT.get(site, ()):
                assert torch.equal(g, w)
            else:
                assert (g - w).abs().max() <= 1e-6 * w.abs().max()
        if site == "gate logits":
            assert all(torch.equal(g, f)
                       for g, f in zip(got, r[site]["former"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_under_the_refusals(ranks, arch):
    losses = [r[arch] for r in ranks]
    assert len(losses[0]) == 1 and np.isfinite(losses[0][0])
    assert all(x == losses[0] for x in losses)


def test_dryrun_cell_under_the_refusals():
    code = (f"import runpy, sys\nsys.path.insert(0, {TESTS!r})\n"
            "from _dtensor_guard import refusing_as_torch_2_11\n"
            "sys.argv = ['dryrun', '--arch', 'recurrentgemma-2b', "
            "'--shape', 'train_4k', '--reduced']\n"
            "with refusing_as_torch_2_11():\n"
            "    runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=JOIN_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "[dryrun] done: 1/1 OK" in out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_world1_dtensor_step_is_the_stacked_step(world1, arch):
    (la, ga, pa), (lb, gb, pb) = world1[arch]
    assert la == lb and ga == gb
    assert torch.equal(pa, pb)
