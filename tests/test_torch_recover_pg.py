"""The fault loop, the sharded checkpoint, the sync telemetry, the trace and
the wave timer of ``launch/train.py`` over 4 gloo ranks, against the
stacked run of this process.

Two spawns of 4 ranks under the environment ``torchrun`` sets (a
``file://`` store under the test's temporary directory, each rank joined
with its own timeout) train the reduced smollm-135m on the 4x4 torus (4
vertices a rank):

* ``--recover`` with the probe's view of one link of tree 0 masked from
  step 1: every rank retries, then flips at the same step, with the same
  journal; losses and parameters equal the stacked run bit for bit;
* ``--recover`` with a link of each tree masked (a burst no precompiled
  class survives): the background rebuild is made 2 s slow on rank 1
  only, and every rank still adopts it at the same tick, its journal rows
  (the agreed clock's MTTR included) identical across the ranks;
* a node loss fed to a recovery controller whose ``on_rescale`` callback
  is 0.5 s slow on rank 1 only: every rank journals the same rescale,
  its MTTR (read on the monitor's agreed clock) covering the 0.5 s;
* ``--zero1 --ckpt-dir``: 2 steps saved each step by the 4 ranks, resumed
  to 3, equal to the stacked uninterrupted run; the step-2 checkpoint
  equal to the stacked run's, file for file and array for array, and the
  stacked checkpoint restored onto each rank's rows;
* telemetry's ``sync_dev`` of a dense edst step equal to the stacked
  step's, and one flipped bit in one row of one rank's allgathered params
  read by every rank as ``ag_replicas_equal`` False;
* ``--trace-out`` (rank 0 writes) equal to the stacked run's trace, and
  ``timed_waves`` over the group with the stacked program's wave count;
* ``--recover --zero1`` and ``--recover --quantize-grads`` on the striped
  engine still refused.
"""
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.ckpt import restore_sharded
from repro_torch.core.collectives import owner_element_map
from repro_torch.core.fault import FailureEvent
from repro_torch.core.graph import canon
from repro_torch.data import SyntheticLMStream
from repro_torch.dist import health, steps
from repro_torch.dist.fabric import ProcessGroupFabric
from repro_torch.dist.fault import FaultAwareAllreduce
from repro_torch.dist.recovery import RecoveryController
from repro_torch.dist.steps import (edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.launch import train
from repro_torch.models.api import build
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.telemetry.timing import timed_waves
from test_torch_fabric_pg import one_thread, spawn_ranks
from test_torch_train_pg import _flat

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")
BASE = ["--reduced", "--batch", "16", "--seq", "16", "--device", "cpu",
        "--log-every", "1", "--mesh", "4,4,1"]
RECOVER = BASE + ["--sync", "edst", "--recover", "--steps", "4"]
SLOW_RANK, SLOW_S = 1, 2.0
RESCALE_S, LOST = 0.5, 5
WAVE_BYTES = 4096


def torchrun_env(rank, world):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))


def _runtime():
    return fault_runtime_for_mesh(SHAPE, NAMES)


def _kill():
    """A link of tree 0: a precompiled class survives it."""
    return {sorted(_runtime().entries[0].sched.trees[0].tree)[0]}


def _burst():
    """A link of each tree that no precompiled class survives."""
    rt = _runtime()
    t0, t1 = (sorted(t.tree) for t in rt.entries[0].sched.trees)
    for a in t0:
        for b in t1:
            if not rt.valid_ids(FailureEvent(links=frozenset({a, b}))):
                return {a, b}
    raise AssertionError("every pair of links has a surviving class")


CHECK = health.HealthMonitor.check


def _masked(dead, from_step=1):
    """``HealthMonitor.check`` with the probe's view of the ``dead``
    links masked from ``from_step`` on."""
    orig = CHECK

    def check(self, step, fault_mask=None, **kw):
        if step >= from_step:
            fault_mask = [0.0 if canon(*link) in dead else 1.0
                          for link in self.links]
        return orig(self, step, fault_mask=fault_mask, **kw)
    return check


def _slow_rebuild():
    orig = FaultAwareAllreduce.with_rebuild

    def with_rebuild(self, event):
        time.sleep(SLOW_S)
        return orig(self, event)
    return with_rebuild


def _result(res):
    return {"losses": res.losses, "grad_norms": res.grad_norms,
            "params": _flat(res.params),
            "journal": res.controller.journal_rows(),
            "schedule": res.controller.schedule_id,
            "generation": res.controller.generation,
            "sync_dev": res.metrics.get("sync_dev")}


def _loops(slow: bool) -> dict:
    """The two ``--recover`` runs, patched as the module docstring says
    (the patches undone after)."""
    out = {}
    orig_rebuild = FaultAwareAllreduce.with_rebuild
    try:
        health.HealthMonitor.check = _masked(_kill())
        out["kill"] = _result(train.main(RECOVER))
        health.HealthMonitor.check = _masked(_burst())
        if slow:
            FaultAwareAllreduce.with_rebuild = _slow_rebuild()
        out["burst"] = _result(train.main(RECOVER))
    finally:
        health.HealthMonitor.check = CHECK
        FaultAwareAllreduce.with_rebuild = orig_rebuild
    return out


def _rescale(slow: bool) -> list:
    """The journal of one tick whose probe loses every link of vertex
    ``LOST``, on the group's fabric, the ``on_rescale`` callback sleeping
    ``RESCALE_S`` first where ``slow``."""
    rt = _runtime()
    fabric = ProcessGroupFabric(rt.graph.n, "cpu")
    mon = health.HealthMonitor(fabric, rt)

    def on_rescale(event):
        if slow:
            time.sleep(RESCALE_S)
        return _runtime()

    ctrl = RecoveryController(rt, clock=mon.clock, agree=fabric.all_true,
                              on_rescale=on_rescale)
    mask = [0.0 if LOST in link else 1.0 for link in mon.links]
    assert ctrl.observe(mon.check(0, fault_mask=mask)).action == "rescale"
    return ctrl.journal_rows()


def _loop_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    torchrun_env(rank, world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = _loops(rank == SLOW_RANK)
        out["rescale"] = _rescale(rank == SLOW_RANK)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _quad(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def _replicas_equal(group, flip: bool) -> bool:
    """One telemetry zero1 step of a small quadratic problem; ``flip``
    flips one bit of one allgathered row of this rank first."""
    g = torch.Generator().manual_seed(4)
    params = {"w": torch.randn(40, 3, generator=g),
              "b": torch.randn(3, generator=g)}
    batch = {"x": torch.randn(32, 40, generator=g),
             "y": torch.randn(32, 3, generator=g)}
    opt = AdamW(cosine_schedule(1e-2, 2, 20))
    orig = steps.tree_allgather

    def flipped(*args, **kw):
        rows = orig(*args, **kw)
        rows[1].view(torch.int32)[5] ^= 1
        return rows

    step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                           engine="striped", loss=_quad, telemetry=True,
                           group=group)
    fabric = ProcessGroupFabric(16, "cpu", group) if group is not None \
        else None
    st = ShardedAdamW(opt).init_for(
        params, edst_spec_for_mesh(SHAPE, NAMES, engine="striped"), 16,
        fabric=fabric)
    if flip:
        steps.tree_allgather = flipped
    try:
        return step(params, st, batch)[2]["ag_replicas_equal"]
    finally:
        steps.tree_allgather = orig


def _telemetry_step(group):
    cfg = configs.get("smollm-135m").reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    batch = {"tokens": torch.as_tensor(
        SyntheticLMStream(cfg.vocab, 16, 16, seed=0).batch(0),
        dtype=torch.long)}
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    step = make_train_step(api, opt, SHAPE, NAMES, mode="edst",
                           telemetry=True, group=group)
    m = step(params, opt.init(params), batch)[2]
    return {k: float(m[k]) for k in ("loss", "grad_norm", "sync_dev",
                                     "sync_grad_norm", "sync_wire_bytes")}


def _zero1_ckpt(ck, trace):
    """The ``--zero1 --ckpt-dir`` runs (2 steps saved each step, then
    resumed to 3) and a 1-step ``--trace-out`` run."""
    z = BASE + ["--zero1", "--ckpt-dir", str(ck)]
    train.main(z + ["--steps", "2", "--ckpt-every", "1"])
    res = train.main(z + ["--steps", "3"])
    train.main(BASE + ["--sync", "edst", "--steps", "1", "--trace-out",
                       str(trace)])
    return {"start": res.start_step, "losses": res.losses,
            "params": _flat(res.params), "mu": res.opt_state.mu,
            "nu": res.opt_state.nu}


def _restore_rows(ck, fabric):
    cfg = configs.get("smollm-135m").reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0),
                             torch.device("cpu"))
    size = sum(p.numel() for p in train.tree_leaves(params))
    spec = edst_spec_for_mesh(SHAPE, NAMES, engine="striped")
    return restore_sharded(str(ck), params, owner_element_map(spec, size),
                           step=2, fabric=fabric)[1]


def _refusals() -> dict:
    out = {}
    for what, extra in {"--recover --zero1": ["--zero1"],
                        "--recover --quantize-grads striped": [
                            "--quantize-grads", "--edst-engine",
                            "striped"]}.items():
        try:
            train.main(RECOVER + extra)
        except SystemExit as e:
            out[what] = e.code
    return out


def _rest_rank(rank, world, init, out_dir, stacked_ck):
    torch.set_num_threads(1)
    torchrun_env(rank, world)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        group = dist.group.WORLD
        out = _zero1_ckpt(Path(out_dir) / "ck", Path(out_dir) / "trace.json")
        fabric = ProcessGroupFabric(16, "cpu")
        out["block"] = (fabric.lo, fabric.hi)
        st = _restore_rows(stacked_ck, fabric)
        out["restored"] = (st.mu, st.nu)
        spec = edst_spec_for_mesh(SHAPE, NAMES)
        out["waves"] = timed_waves(spec, WAVE_BYTES, iters=1, device="cpu",
                                   group=group)
        out["telemetry"] = _telemetry_step(group)
        out["replicas"] = (_replicas_equal(group, False),
                           _replicas_equal(group, rank == 2))
        out["refused"] = _refusals()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def stacked(tmp_path_factory):
    """Every run on the stacked fabric of this process."""
    assert "WORLD_SIZE" not in os.environ
    tmp = tmp_path_factory.mktemp("recover_stacked")
    with one_thread():
        out = _loops(False)
        out.update(_zero1_ckpt(tmp / "ck", tmp / "trace.json"))
        out["restored"] = _restore_rows(tmp / "ck", None)
        out["waves"] = len(edst_spec_for_mesh(SHAPE, NAMES).waves)
        out["telemetry"] = _telemetry_step(None)
        out["replicas"] = _replicas_equal(None, False)
    out["dir"] = tmp
    return out


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("recover_pg"), _loop_rank)


@pytest.fixture(scope="module")
def rest(stacked, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recover_pg_rest")
    got = spawn_ranks(tmp, _rest_rank, args=(str(stacked["dir"] / "ck"),))
    return got, tmp


@pytest.mark.parametrize("run", ("kill", "burst"))
def test_every_rank_decides_alike(loops, run):
    """The same journal (ticks and the agreed clock's MTTR included), the
    same schedule, generation, losses and parameters on every rank."""
    first = loops[0][run]
    assert first["journal"]
    for got in loops[1:]:
        got = got[run]
        assert got["journal"] == first["journal"]
        for key in ("schedule", "generation", "losses", "grad_norms"):
            assert got[key] == first[key], key
        assert torch.equal(got["params"], first["params"])


def test_masked_link_flips_every_rank_at_the_same_step(loops, stacked):
    for got in loops:
        rows = got["kill"]["journal"]
        flips = [r for r in rows if r["action"] == "flip"]
        assert len(flips) == 1 and flips[0]["cause"] == "link-kill"
        # a retry at step 1, then the flip on the redo of step 1
        assert flips[0]["step"] == 1 and flips[0]["steps_degraded"] == 0
        assert got["kill"]["schedule"] == flips[0]["to_schedule"] != 0


@pytest.mark.parametrize("run", ("kill", "burst"))
def test_recover_equals_the_stacked_run(loops, stacked, run):
    """Bit for bit with the stacked loop: the committed steps' losses and
    grad norms, the parameters, the final schedule and the journal but
    for the wall-clock MTTR."""
    want = stacked[run]
    for got in loops:
        got = got[run]
        assert got["losses"] == want["losses"]
        assert got["grad_norms"] == want["grad_norms"]
        assert torch.equal(got["params"], want["params"])
        assert (got["schedule"], got["generation"]) == \
            (want["schedule"], want["generation"])
        strip = [{k: v for k, v in r.items() if k != "mttr_s"}
                 for r in got["journal"]]
        assert strip == [{k: v for k, v in r.items() if k != "mttr_s"}
                         for r in want["journal"]]
        assert got["sync_dev"] == want["sync_dev"]


def test_slow_rebuild_adopted_at_one_tick_everywhere(loops):
    """Rank 1's rebuild takes 2 s more than the others'; every rank hot
    swaps at the same tick, after it (the agreed MTTR covers the 2 s)."""
    for got in loops:
        rows = got["burst"]["journal"]
        swaps = [r for r in rows if r["action"] == "hot-swap"]
        assert len(swaps) == 1 and swaps[0]["cause"] == "link-burst"
        assert swaps[0]["mttr_s"] >= SLOW_S
        assert got["burst"]["generation"] == 1


def test_rescale_mttr_agreed_on_every_rank(loops):
    """A node loss rescales every rank at the same tick, with one journal:
    the MTTR, read on the monitor's agreed clock, covers rank 1's slow
    ``on_rescale`` on every rank."""
    first = loops[0]["rescale"]
    assert [(r["cause"], r["action"]) for r in first] == \
        [("node-loss", "rescale")]
    assert first[0]["detail"]["nodes"] == [LOST]
    assert first[0]["mttr_s"] >= RESCALE_S
    for got in loops[1:]:
        assert got["rescale"] == first


def test_zero1_ckpt_resumes_over_ranks(rest, stacked):
    got, _ = rest
    for r in got:
        lo, hi = r["block"]
        assert r["start"] == 2 and len(r["losses"]) == 1
        assert r["losses"] == stacked["losses"]
        assert torch.equal(r["params"], stacked["params"])
        assert r["mu"].shape[0] == 4
        assert torch.equal(r["mu"], stacked["mu"][lo:hi])
        assert torch.equal(r["nu"], stacked["nu"][lo:hi])


def test_zero1_ckpt_files_equal_the_stacked_run(rest, stacked):
    """The 4 ranks' step-2 checkpoint: the stacked one's files, each
    array equal, the manifest equal but for the shards' CRC32 (each file
    holds its write time)."""
    _, tmp = rest
    a = tmp / "ck" / "step_00000002"
    b = stacked["dir"] / "ck" / "step_00000002"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert len([n for n in names if n.startswith("shard_")]) == 16
    for name in names:
        if name == "manifest.json":
            ma, mb = (json.loads((d / name).read_text()) for d in (a, b))
            assert set(ma["sharded"].pop("checksums")) == \
                set(mb["sharded"].pop("checksums"))
            assert ma == mb
            continue
        with np.load(a / name) as x, np.load(b / name) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert np.array_equal(x[k], y[k]), (name, k)


def test_ckpt_restores_onto_either_fabric(rest, stacked):
    """The stacked checkpoint onto each rank's rows, and the ranks'
    checkpoint onto the stacked fabric."""
    got, tmp = rest
    want = stacked["restored"]
    for r in got:
        lo, hi = r["block"]
        assert torch.equal(r["restored"][0], want.mu[lo:hi])
        assert torch.equal(r["restored"][1], want.nu[lo:hi])
    with one_thread():
        st = _restore_rows(tmp / "ck", None)
    assert torch.equal(st.mu, want.mu) and torch.equal(st.nu, want.nu)


def test_trace_out_equals_the_stacked_trace(rest, stacked):
    _, tmp = rest
    got = json.loads((tmp / "trace.json").read_text())
    want = json.loads((stacked["dir"] / "trace.json").read_text())
    assert got == want and got["traceEvents"]


def test_wave_timer_over_the_group(rest, stacked):
    got, _ = rest
    dev, host = got[0]["waves"]
    assert len(dev) == len(host) == stacked["waves"]
    assert all(t > 0 for t in dev)
    for r in got[1:]:       # each wave's maximum over the ranks
        assert r["waves"] == got[0]["waves"]


def test_telemetry_equals_the_stacked_step(rest, stacked):
    for r in rest[0]:
        assert r["telemetry"] == stacked["telemetry"]


def test_flipped_bit_reads_replicas_unequal_on_every_rank(rest, stacked):
    assert stacked["replicas"]
    for r in rest[0]:
        assert r["replicas"] == (True, False)


@pytest.mark.parametrize("what", ("--recover --zero1",
                                  "--recover --quantize-grads striped"))
def test_still_refused_over_ranks(rest, what):
    for r in rest[0]:
        assert r["refused"].get(what) == 2, r["refused"]
