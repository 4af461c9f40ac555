"""ZeRO-1 over 4 gloo ranks against the stacked fabric and the reference.

One spawn of 4 ranks (``torch.multiprocessing``, a ``file://`` store under
the test's temporary directory, each rank joined with its own timeout)
runs the reference's toy zero1 problem (``tests/test_zero1_jax.py``: a
quadratic loss over ``{"w": (6, 8), "b": (5,)}``, 53 elements on the 16
vertices of the 4x4 torus, 4 a rank): f32 for 5 steps, the int8 gradient
wire (``codec="full"``), ``m = 7 < n`` (``{"w": (2, 2), "b": (3,)}``), and
the f32 run through the striped fault runtime with a link of tree 0
killed after 3 steps (flip to the degraded class, mu and nu moved by a
cross-rank ``reshard_owned``, there and back, 3 more steps).  Each rank
holds the moments of its own 4 vertices only.  Every rank's losses, grad
norms, parameters, moment rows and ``sync_dev`` must equal the stacked
run of this process bit for bit, and the moments gathered over the ranks
must stay within the reference's own tolerances of its zero1 run (loss
1e-5, grad norm 1e-4, parameters and moments 1e-6; int8 1e-3 / 1e-2),
which runs once for the module in a subprocess on 16 fake host devices
with Auto axes (``tests/test_torch_zero1.py``'s, unpatched).
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.fault import FailureEvent
from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
from repro_torch.dist.steps import (edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from test_torch_fabric_pg import one_thread, spawn_ranks

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")
STEPS = 5
# tag -> quantized: the reference's cases (test_torch_zero1.PROBLEMS)
PROBLEMS = {"plain": False, "q8": True, "small": False}
TOL = {"plain": (1e-5, 1e-4), "q8": (1e-3, 1e-2), "small": (1e-5, 1e-4),
       "kill": (1e-5, 1e-4)}
TAGS = tuple(PROBLEMS) + ("kill",)
SIZE = 53


def quad(params, batch):
    """The reference's QuadAPI loss."""
    pred = torch.einsum("bij,ij->b", batch["x"], params["w"]) \
        + batch["x2"] @ params["b"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def _problem(inp, tag):
    params = {"w": torch.from_numpy(inp[tag + "/w"]),
              "b": torch.from_numpy(inp[tag + "/b"])}
    batch = {k: torch.from_numpy(inp[tag + "/" + k]) for k in ("x", "x2", "y")}
    return params, batch


def _flat(p):
    return torch.cat([t.reshape(-1) for t in tree_leaves(p)])


def _record(p, st, m):
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _flat(p).clone(), "mu": st.mu.clone(),
            "nu": st.nu.clone(), "sync_dev": m["sync_dev"],
            "ag_replicas_equal": m["ag_replicas_equal"], "step": st.step}


def _runs(inp, fabric, group):
    """Every case on ``fabric`` (the stacked one, or this rank's block of
    the process group ``group``): ``{tag: [per-step record]}``, and the
    fault run's reshard checks."""
    opt = AdamW(cosine_schedule(1e-2, 2, 20))
    sopt = ShardedAdamW(opt)
    spec = edst_spec_for_mesh(SHAPE, NAMES, engine="striped")
    out = {}
    for tag, q in PROBLEMS.items():
        params, batch = _problem(inp, tag)
        step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                               engine="striped", quantize=q,
                               codec="full" if q else None, loss=quad,
                               telemetry=True, group=group)
        st = sopt.init_for(params, spec, 16, fabric=fabric)
        out[tag] = []
        for _ in range(STEPS):
            params, st, m = step(params, st, batch)
            out[tag].append(_record(params, st, m))
    params, batch = _problem(inp, "plain")
    rt = fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")
    step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                           fault_runtime=rt, loss=quad, telemetry=True,
                           group=group)
    st = sopt.init_for(params, rt, 16, fabric=fabric)
    out["kill"] = []
    for _ in range(3):
        params, st, m = step(params, st, batch, 0)
        out["kill"].append(_record(params, st, m))
    dead = next(iter(sorted(rt.entries[0].sched.trees[0].tree)))
    sid = rt.on_failure(FailureEvent(links=frozenset({dead})),
                        prefer="degraded").active
    mu = rt.reshard_owned(st.mu, 0, sid, SIZE, fabric)
    back = rt.reshard_owned(mu, sid, 0, SIZE, fabric)
    plans = len(rt._reshard_cache)
    nu = rt.reshard_owned(st.nu, 0, sid, SIZE, fabric)
    again = rt.reshard_owned(rt.reshard_owned(st.mu, 0, sid, SIZE, fabric),
                             sid, 0, SIZE, fabric)
    out["reshard"] = {"sid": sid, "there": mu.clone(),
                      "back_equal": torch.equal(back, st.mu),
                      "again_equal": torch.equal(again, st.mu),
                      "plans": (plans, len(rt._reshard_cache))}
    st = type(st)(st.step, mu, nu)
    for _ in range(3):
        params, st, m = step(params, st, batch, sid)
        out["kill"].append(_record(params, st, m))
    return out


def _rank_main(rank, world, init, out_dir, inp_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        inp = dict(np.load(inp_path))
        fabric = ProcessGroupFabric(16, "cpu")
        out = _runs(inp, fabric, dist.group.WORLD)
        out["block"] = (fabric.lo, fabric.hi)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    """The reference's zero1 runs (``tests/test_torch_zero1.py``'s
    subprocess) and their inputs."""
    import test_torch_zero1 as Z
    path = tmp_path_factory.mktemp("zero1_pg") / "ref"
    inp = Z._inputs()
    np.savez(str(path) + ".in.npz", **inp)
    subproc(f"OUT = {str(path)!r}\nSTEPS = {STEPS}\n" + Z.CODE, 16)
    return str(path) + ".in.npz", inp, dict(np.load(str(path) + ".npz"))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("zero1_pg_ranks"), _rank_main,
                       args=(reference[0],))


@pytest.fixture(scope="module")
def stacked(reference):
    with one_thread():
        return _runs(reference[1], StackedFabric(16, "cpu"), None)


@pytest.mark.parametrize("tag", TAGS)
def test_ranks_equal_the_stacked_run(ranks, stacked, tag):
    for r, got in enumerate(ranks):
        lo, hi = got["block"]
        assert (lo, hi) == (4 * r, 4 * r + 4)
        for s, (g, w) in enumerate(zip(got[tag], stacked[tag])):
            assert g["loss"] == w["loss"], (r, s)
            assert g["grad_norm"] == w["grad_norm"], (r, s)
            assert torch.equal(g["params"], w["params"]), (r, s)
            for k in ("mu", "nu"):
                assert g[k].shape[0] == 4, (r, k)      # its own rows only
                assert torch.equal(g[k], w[k][lo:hi]), (r, s, k)
            assert g["step"] == w["step"] == s + 1


@pytest.mark.parametrize("tag", TAGS)
def test_sync_dev_equal_the_stacked_run(ranks, stacked, tag):
    """Telemetry's ``sync_dev`` (the scattered domain's conservation gap,
    from per-row sums gathered in vertex order) and the allgathered rows'
    check, on every rank."""
    for got in ranks:
        for g, w in zip(got[tag], stacked[tag]):
            assert g["sync_dev"] == w["sync_dev"]
            assert g["ag_replicas_equal"] and w["ag_replicas_equal"]


@pytest.mark.parametrize("tag", TAGS)
def test_ranks_within_reference_tolerances(reference, ranks, tag):
    ref = reference[2]
    tl, tg = TOL[tag]
    for s in range(len(ranks[0][tag])):
        rl = float(ref[f"{tag}/{s}/loss"])
        rg = float(ref[f"{tag}/{s}/grad_norm"])
        for got in ranks:
            g = got[tag][s]
            assert abs(g["loss"] - rl) <= tl * abs(rl), (tag, s)
            assert abs(g["grad_norm"] - rg) <= tg * max(rg, 1e-9), (tag, s)
            assert np.max(np.abs(g["params"].numpy()
                                 - ref[f"{tag}/{s}/params"])) <= 1e-6
        for k in ("mu", "nu"):
            whole = torch.cat([got[tag][s][k] for got in ranks]).numpy()
            assert whole.shape == ref[f"{tag}/{s}/{k}"].shape
            assert np.max(np.abs(whole - ref[f"{tag}/{s}/{k}"])) <= 1e-6


def test_cross_rank_reshard_there_and_back(reference, ranks, stacked):
    """The flip's reshard moves elements between ranks: each rank's new
    rows equal the stacked reshard's, and the flip back restores the
    state bit for bit."""
    want = stacked["reshard"]
    assert want["sid"] == int(reference[2]["kill/sid"]) != 0
    moved = 0
    for got in ranks:
        lo, hi = got["block"]
        rs = got["reshard"]
        assert rs["sid"] == want["sid"]
        assert torch.equal(rs["there"], want["there"][lo:hi])
        assert rs["back_equal"] and rs["again_equal"]
        before = stacked["kill"][2]["mu"]
        # elements of this rank's new rows that another rank held before
        mine = set(before[lo:hi].reshape(-1).tolist()) - {0.0}
        moved += sum(v not in mine
                     for v in rs["there"].reshape(-1).tolist() if v)
    assert moved > 0


def test_reshard_plans_cached_per_flip(ranks):
    """A repeated flip and the flip back build no new plan: one a
    direction, built by the first there-and-back."""
    for got in ranks:
        assert got["reshard"]["plans"] == (2, 2)
