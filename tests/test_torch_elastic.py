"""The port's elastic rescale against the reference's: the Roskind-Tarjan
rescale after a node loss (relabel map, runtime, entry tables, and the
cache identity on a repeat), the failure drill's JSON report, the DP
fabric's ``dp_torus_shape``, and the spec rebuild for a new mesh.  On
the port alone: the elastic CLI restores a checkpoint of the train entry
point bit for bit, the train loop's node-loss stop names the relaunch
and the relaunch resumes, and the closed chaos loop
(``elastic.chaos_loop``) at a reduced size on the CPU (16 vertices, a
seeded trace of all six kinds) ends on the 2x4 torus with every
recovery's first step held to ``psum_dp``, no unhandled exception, and
a relaunch from its checkpoint that repeats its losses."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro.core.fault import FailureEvent as JEvent
from repro.dist import steps as jsteps
from repro.launch import elastic as jel
from repro_torch import configs
from repro_torch.core.fault import FailureEvent
from repro_torch.dist import steps as tsteps
from repro_torch.dist.fault import NoScheduleError
from repro_torch.launch import elastic, train
from repro_torch.models.api import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from test_torch_fault import _sched_equal
from test_torch_schedules import _spec_equal
from test_torch_train_fault import BASE, _inject

MESH = ((16, 1), ("data", "model"))
TORUS = (4, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rts():
    """(reference runtime, port runtime) of the 4x4 torus."""
    return (jsteps.fault_runtime_for_mesh(*MESH, dp_torus_shape=TORUS),
            tsteps.fault_runtime_for_mesh(*MESH, dp_torus_shape=TORUS))


def _flat(tree):
    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])


def _runtimes_equal(mine, ref):
    assert mine.graph.n == ref.graph.n and mine.graph.edges == ref.graph.edges
    assert (mine.axes, mine.engine, mine.active) == (ref.axes, ref.engine,
                                                     ref.active)
    assert len(mine.entries) == len(ref.entries)
    for em, er in zip(mine.entries, ref.entries):
        assert (em.name, em.fractions, em.k, em.depth) == \
            (er.name, er.fractions, er.k, er.depth)
        _sched_equal(er.sched, em.sched, em.name)
        _spec_equal(mine.engine, em.spec, er.spec)


@pytest.mark.parametrize("node", [3, 0, 10])
def test_rescale_after_node_loss_matches_reference(rts, node):
    jrt, trt = rts
    mine, rel = elastic.rescale_after_node_loss(
        trt, FailureEvent(nodes=frozenset({node})))
    ref, jrel = jel.rescale_after_node_loss(
        jrt, JEvent(nodes=frozenset({node})))
    assert rel == jrel and sorted(rel.values()) == list(range(15))
    assert node not in rel
    _runtimes_equal(mine, ref)
    assert mine.history == ref.history == [("rescaled", 15)]
    assert mine.k == 2 and len(mine.graph.edges) == 28
    for i, e in enumerate(mine.entries):
        assert mine.verify_entry(i, static=True) == (e.k > 0), e.name


def test_rescale_onto_same_fabric_reuses_cached_specs(rts):
    """Two rescales landing on the SAME surviving fabric share every
    compiled entry spec object, while history stays per runtime."""
    rt = rts[1]
    ev = FailureEvent(nodes=frozenset({3}))
    a, rel_a = elastic.rescale_after_node_loss(rt, ev)
    b, rel_b = elastic.rescale_after_node_loss(rt, ev)
    assert rel_a == rel_b
    assert b is not a
    assert b.entries is a.entries
    assert b._reshard_cache is a._reshard_cache
    assert all(ea.spec is eb.spec for ea, eb in zip(a.entries, b.entries))
    assert a.history == b.history == rt.history + [("rescaled",
                                                    rt.graph.n - 1)]
    a.history.append("mine")
    assert b.history != a.history


def test_rescale_refuses_a_disconnected_fabric(rts):
    rt = rts[1]
    # every neighbour of vertex 0 lost: 0 is cut off from the rest
    nbrs = {v for e in rt.graph.edges for v in e if 0 in e} - {0}
    with pytest.raises(NoScheduleError):
        elastic.rescale_after_node_loss(rt, FailureEvent(nodes=frozenset(
            nbrs)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("events", [3, 6])
def test_failure_drill_matches_reference(rts, seed, events):
    jrt, trt = rts
    kinds = ("link", "burst", "node")
    mine = elastic.failure_drill(trt, n_events=events, seed=seed,
                                 kinds=kinds)
    ref = jel.failure_drill(jrt, n_events=events, seed=seed, kinds=kinds)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert all(e["sim_ok"] for e in mine["events"])
    with pytest.raises(ValueError):
        elastic.failure_drill(trt, n_events=1, kinds=("meteor",))


def test_failure_drill_cli_matches_reference():
    argv = ["--failure-drill", "--to-mesh", "4,4", "--events", "3"]
    outs = []
    for main in (elastic.main, jel.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(argv)
        outs.append(json.loads(out.getvalue()))
    assert outs[0] == outs[1]


def test_dp_torus_shape_matches_reference():
    names = MESH[1]
    sp, dp = tsteps.dp_fabric_for_mesh(MESH[0], names, TORUS)
    jsp, jdp = jsteps.dp_fabric_for_mesh(MESH[0], names, TORUS)
    assert dp == jdp == ("data",)
    assert sp.product().edges == jsp.product().edges
    for engine in ("pipelined", "fused", "striped"):
        spec = tsteps.edst_spec_for_mesh(*MESH, TORUS, engine=engine)
        assert tsteps.edst_spec_for_mesh(*MESH, dp_torus_shape=TORUS,
                                         engine=engine) is spec
        _spec_equal(engine, spec,
                    jsteps.edst_spec_for_mesh(*MESH, TORUS, engine=engine))
    assert tsteps.edst_spec_for_mesh(*MESH, TORUS).k == 2
    assert tsteps.edst_spec_for_mesh(*MESH).k == 1      # the ring 16
    for bad in ((4, 2), (3, 5)):
        with pytest.raises(ValueError, match="dp_torus_shape"):
            tsteps.dp_fabric_for_mesh(MESH[0], names, bad)
        with pytest.raises(ValueError, match="dp_torus_shape"):
            tsteps.fault_runtime_for_mesh(*MESH, dp_torus_shape=bad)
    _runtimes_equal(
        tsteps.fault_runtime_for_mesh(*MESH, dp_torus_shape=TORUS),
        jsteps.fault_runtime_for_mesh(*MESH, dp_torus_shape=TORUS))


def test_make_train_step_takes_the_torus_shape():
    """The step over the flat 16-vertex data axis, given the fault runtime
    ``fault_runtime_for_mesh`` builds with ``dp_torus_shape``, runs the
    4x4 torus's program: the same result, bit for bit, as the step on the
    (4, 4, 1) mesh, and not the ring's."""
    rng = np.random.RandomState(0)
    params = {"w": torch.tensor(rng.randn(6, 8), dtype=torch.float32),
              "b": torch.tensor(rng.randn(5), dtype=torch.float32)}
    batch = {"x": torch.tensor(rng.randn(16, 6, 8), dtype=torch.float32),
             "x2": torch.tensor(rng.randn(16, 5), dtype=torch.float32),
             "y": torch.tensor(rng.randn(16), dtype=torch.float32)}

    def loss(p, b):
        pred = torch.einsum("bij,ij->b", b["x"], p["w"]) + b["x2"] @ p["b"]
        return ((pred - b["y"]) ** 2).mean(), {}

    opt = AdamW(cosine_schedule(1e-2, 5, 20))
    out = {}
    for tag, mesh, names, shape in (
            ("flat", (16, 1), ("data", "model"), TORUS),
            ("torus", (4, 4, 1), ("pod", "data", "model"), None),
            ("ring", (16, 1), ("data", "model"), None)):
        rt = tsteps.fault_runtime_for_mesh(mesh, names, dp_torus_shape=shape)
        step = tsteps.make_train_step(None, opt, mesh, names, loss=loss,
                                      fault_runtime=rt, telemetry=True)
        new, _, met = step(params, opt.init(params), batch, 0)
        out[tag] = (_flat(new), met["sync_wire_bytes"])
    assert torch.equal(out["flat"][0], out["torus"][0])
    assert out["flat"][1] == out["torus"][1] != out["ring"][1]


def test_rebuild_schedule_and_survivor_mesh():
    names = ("pod", "data", "model")
    assert elastic.rebuild_schedule((1, 1, 1), names) is None
    spec = elastic.rebuild_schedule((2, 4, 1), names)
    assert spec is tsteps.edst_spec_for_mesh((2, 4, 1), names)
    assert spec is elastic.rebuild_schedule((2, 4, 1), names)
    assert spec.k == 1 and spec.n == 8
    assert elastic.rebuild_schedule((4, 4, 1), names).k == 2
    assert [elastic.survivor_mesh(n) for n in (15, 8, 7, 4, 3, 2)] == \
        [(2, 4, 1), (2, 4, 1), (2, 2, 1), (2, 2, 1), (1, 2, 1), (1, 2, 1)]
    with pytest.raises(NoScheduleError):
        elastic.survivor_mesh(1)


# ---------------------------------------------------------------------------
# checkpoints, the train loop's node-loss stop, and the relaunch
# ---------------------------------------------------------------------------

def test_node_loss_stop_names_the_relaunch_which_resumes(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``--recover`` loses vertex 3 from step 1 on: the loop checkpoints
    the state before that step and stops, naming the relaunch; the
    elastic CLI restores that checkpoint bit for bit onto the 2x4 torus
    (k = 1), and the train entry point resumes there, its first step
    held to psum_dp on the 2x4 torus."""
    _inject(monkeypatch, 1, lambda plan: {l for l in plan.links if 3 in l})
    ck = str(tmp_path / "ck")
    stopped = train.main(BASE + ["--recover", "--steps", "4", "--ckpt-dir",
                                 ck])
    assert len(stopped.losses) == 1
    said = capsys.readouterr().out
    assert (f"python -m repro_torch.launch.elastic --ckpt-dir {ck} "
            "--to-mesh 2,4,1, then python -m repro_torch.launch.train "
            f"--mesh 2,4,1 --ckpt-dir {ck}") in said
    monkeypatch.undo()

    params, opt_state, step = elastic.main(
        ["--ckpt-dir", ck, "--to-mesh", "2,4,1", "--arch", "smollm-135m",
         "--reduced", "--device", "cpu"])
    assert "resumed step 1 onto mesh (2, 4, 1); EDST schedule rebuilt " \
           "with k=1 trees" in capsys.readouterr().out
    assert step == 1
    assert elastic.same_state(params, opt_state, stopped.params,
                              stopped.opt_state)

    base = ["2,4,1" if a == "4,4,1" else a for a in BASE]
    resumed = train.main(base + ["--sync", "edst", "--steps", "3",
                                 "--ckpt-dir", ck], keep_first_step=True)
    assert resumed.start_step == 1 and len(resumed.losses) == 2
    assert torch.equal(_flat(resumed.init_params), _flat(params))
    cfg = configs.get("smollm-135m").reduced()
    batch = {"tokens": torch.as_tensor(resumed_batch(cfg, 1),
                                       dtype=torch.long)}
    opt = AdamW(cosine_schedule(3e-4, 20, 3))
    rel, gn_rel = held_to_psum(cfg, params, opt_state, batch,
                               resumed.first_step_params,
                               resumed.grad_norms[0], (2, 4, 1), opt)
    assert rel <= 1e-5 and gn_rel <= 1e-5, (rel, gn_rel)


def resumed_batch(cfg, step):
    from repro_torch.data import SyntheticLMStream
    return SyntheticLMStream(cfg.vocab, 16, 16, seed=0).batch(step)


def test_elastic_cli_errors(tmp_path):
    with pytest.raises(SystemExit):
        elastic.main(["--to-mesh", "2,4,1"])
    with pytest.raises(FileNotFoundError):
        elastic.main(["--ckpt-dir", str(tmp_path), "--to-mesh", "2,4,1",
                      "--reduced", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            elastic.main(["--ckpt-dir", str(tmp_path), "--to-mesh", "2,4,1",
                          "--reduced"])


# ---------------------------------------------------------------------------
# the closed chaos loop, reduced, on the CPU
# ---------------------------------------------------------------------------

def held_to_psum(cfg, params, opt_state, batch, new_params, grad_norm, mesh,
                 opt):
    """(move, grad norm) of one step relative to a psum_dp step on
    ``mesh`` from the same params and state."""
    step = tsteps.make_train_step(build(cfg), opt, mesh,
                                  ("pod", "data", "model"), mode="psum_dp")
    ref, _, met = step(params, opt_state, batch)
    p0 = _flat(params)
    d_ref, d = _flat(ref) - p0, _flat(new_params) - p0
    gn_ref = float(met["grad_norm"])
    return (float((d - d_ref).norm() / d_ref.norm()),
            abs(float(grad_norm) - gn_ref) / gn_ref)


def test_closed_chaos_loop_reduced(tmp_path):
    cfg = configs.get("smollm-135m").reduced()
    said = []

    def check(tag, params, opt_state, batch, new_params, grad_norm, mesh,
              opt):
        return (tag, mesh) + held_to_psum(cfg, params, opt_state, batch,
                                          new_params, grad_norm, mesh, opt)

    ck = str(tmp_path / "ck")
    res = elastic.chaos_loop(torch.device("cpu"), cfg, 16, 16, ck, check,
                             say=said.append)
    assert res["unhandled"] == 0, "\n".join(said)
    assert sorted(res["fired"]) == sorted(res["kinds"])
    assert res["mesh"] == (2, 4, 1)
    assert res["redo_equal"] is True and res["restore_equal"] is True
    causes = [(r["cause"], r["action"]) for r in res["journal"]]
    for want in (("link-flap", "retry"), ("link-kill", "flip"),
                 ("link-burst", "hot-swap"), ("straggler", "observe"),
                 ("payload-corruption", "retry"), ("node-loss", "rescale")):
        assert want in causes, (want, causes)
    # the first step after each of the five recoveries, on both fabrics
    assert len(res["checks"]) == 5, res["checks"]
    assert res["checks"][-1][1] == (2, 4, 1)
    for tag, mesh, rel, gn_rel in res["checks"]:
        assert rel <= 1e-5 and gn_rel <= 1e-5, (tag, rel, gn_rel)
    assert all(np.isfinite(res["commits"]))
    assert res["steps_lost"] + len(res["commits"]) >= res["ticks"] - 1
    # the relaunch from the node-loss checkpoint repeats the loop's own
    # losses on the 2x4 torus, bit for bit
    s = res["saved"]["step"]
    assert len(res["commits"]) >= s + 2
    base = ["2,4,1" if a == "4,4,1" else a for a in BASE]
    resumed = train.main(base + ["--sync", "edst", "--steps", str(s + 2),
                                 "--ckpt-dir", ck])
    assert resumed.start_step == s
    assert resumed.losses == res["commits"][s:s + 2]


def test_chaos_loop_leaves_no_tensor_in_a_reference_cycle(tmp_path):
    """The loop's state is freed by reference counting once its result is
    dropped: the controller holds the rescale hook, so the hook must not
    hold the controller (that cycle kept the params, the optimizer state
    and the node-loss checkpoint's copy of both alive until the cycle
    collector ran)."""
    import gc
    cfg = configs.get("smollm-135m").reduced()
    gc.collect()
    gc.disable()
    try:
        res = elastic.chaos_loop(torch.device("cpu"), cfg, 16, 16,
                                 str(tmp_path / "ck"), say=lambda s: None)
        assert res["unhandled"] == 0
        del res
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage
                if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
        gc.collect()
    assert not held, held
