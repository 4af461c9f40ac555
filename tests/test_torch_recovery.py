"""The port's recovery controller against the reference's, on the
reference's scenarios (its ``tests/test_recovery.py``): a flap retried, a
kill confirmed and flipped, an out-of-class burst rebuilt and hot-swapped
(inline and on the background thread), corruption redone then escalated,
a straggler journaled, a node loss stalled without callbacks or
checkpointed and rescaled with them, and the whole ladder in one run.
Both controllers read the same scripted ``HealthReport`` ticks and one
deterministic clock; every decision and every journal row (the JSONL file
too) must be equal, and ``replay_journal`` must give back the live
(generation, schedule id).  Also the ``sid-out-of-range`` check."""
import json
import time

import numpy as np
import pytest

from repro.analysis.verify import check_schedule_id as j_check
from repro.dist import recovery as jrec
from repro.dist.chaos import out_of_class_burst
from repro.dist.fault import FaultAwareAllreduce as JRuntime
from repro.dist.health import HealthReport as JReport
from repro.dist.steps import fault_runtime_for_mesh as j_runtime
from repro_torch.analysis.verify import check_schedule_id as t_check
from repro_torch.core.edst_rt import max_edsts
from repro_torch.core.graph import Graph, canon
from repro_torch.dist import recovery as trec
from repro_torch.dist.fault import FaultAwareAllreduce as TRuntime
from repro_torch.dist.health import HealthReport as TReport
from repro_torch.dist.health import compile_link_probe
from repro_torch.dist.steps import fault_runtime_for_mesh as t_runtime

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")


@pytest.fixture(scope="module")
def runtimes():
    return j_runtime(SHAPE, NAMES), t_runtime(SHAPE, NAMES)


class Clock:
    """A deterministic clock: each read advances by 0.25 s."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _rescaler(build, rt, calls, tag):
    """An ``on_rescale`` that relabels the survivors and repacks them, as
    the reference's ``rescale_after_node_loss`` does."""
    def on_rescale(event):
        calls.append((tag, "rescale"))
        dead = event.dead_links(rt.graph)
        residual = rt.graph.without_edges(dead)
        alive = [v for v in range(rt.graph.n) if v not in event.nodes]
        idx = {v: i for i, v in enumerate(alive)}
        sub = Graph(len(alive), {(idx[u], idx[v]) for u, v in residual.edges
                                 if u in idx and v in idx}, name="rescaled")
        return build(sub, max_edsts(sub)[0], rt.axes)
    return on_rescale


def _pair(runtimes, tmp_path, policy=None, callbacks=False):
    jrt, trt = runtimes
    calls = []
    out = []
    for tag, mod, rt, build in (("ref", jrec, jrt, JRuntime.build),
                                ("port", trec, trt, TRuntime.build)):
        kw = {}
        if callbacks:
            kw = {"on_checkpoint": lambda tag=tag: calls.append(
                      (tag, "ckpt")),
                  "on_rescale": _rescaler(build, rt, calls, tag)}
        pol = None if policy is None else mod.RecoveryPolicy(**policy)
        out.append(mod.RecoveryController(
            rt, pol, clock=Clock(), journal_path=str(tmp_path / f"{tag}.jsonl"),
            **kw))
    return out[0], out[1], calls


def _tick(jctl, tctl, plan, step, dead=(), checksum_dev=0.0,
          straggler=False):
    dead = frozenset(dead)
    ok = np.array([canon(s, d) not in dead for s, d in plan.links])
    kw = dict(step=step, links=plan.links, link_ok=ok,
              checksum_dev=checksum_dev, straggler=straggler,
              step_time=1.0)
    jd = jctl.observe(JReport(**kw))
    td = tctl.observe(TReport(**kw))
    assert (td.action, td.schedule_id, td.stall, td.redo_step, td.backoff_s,
            td.runtime_changed, td.detail) == \
        (jd.action, jd.schedule_id, jd.stall, jd.redo_step, jd.backoff_s,
         jd.runtime_changed, jd.detail), step
    assert (tctl.state, tctl.generation) == (jctl.state, jctl.generation)
    return td


def _journals_equal(jctl, tctl, tmp_path):
    assert tctl.journal_rows() == jctl.journal_rows()
    assert trec.replay_journal(tctl.journal) == \
        jrec.replay_journal(jctl.journal) == \
        (tctl.generation, tctl.schedule_id)
    if tctl.journal:
        jl = (tmp_path / "ref.jsonl").read_text().splitlines()
        tl = (tmp_path / "port.jsonl").read_text().splitlines()
        assert [json.loads(x) for x in tl] == [json.loads(x) for x in jl]
        assert trec.replay_journal(str(tmp_path / "port.jsonl")) == \
            (tctl.generation, tctl.schedule_id)
        rows = [e.to_row() for e in trec.load_journal(
            str(tmp_path / "port.jsonl"))]
        assert rows == tctl.journal_rows()


def _edge(rt, j=0):
    return next(iter(sorted(rt.entries[0].sched.trees[j].tree)))


def _node_dead(plan):
    v = plan.links[0][0]
    return {tuple(sorted((s, d))) for s, d in plan.links if v in (s, d)}


def test_flap_kill_and_straggler(runtimes, tmp_path):
    jctl, tctl, _ = _pair(runtimes, tmp_path)
    plan = compile_link_probe(tctl.runtime)
    edge = _edge(tctl.runtime)
    assert _tick(jctl, tctl, plan, 0, {edge}).action == "retry"
    assert _tick(jctl, tctl, plan, 1).action == "none"        # flap
    assert _tick(jctl, tctl, plan, 2, straggler=True).action == "none"
    _tick(jctl, tctl, plan, 3, {edge})
    assert _tick(jctl, tctl, plan, 4, {edge}).action == "flip"
    assert tctl.schedule_id != 0
    assert [e.cause for e in tctl.journal] == ["link-flap", "straggler",
                                               "link-kill"]
    _journals_equal(jctl, tctl, tmp_path)


@pytest.mark.parametrize("background", [False, True])
def test_burst_rebuilds_and_hot_swaps(runtimes, tmp_path, background):
    jctl, tctl, _ = _pair(runtimes, tmp_path,
                          {"background_rebuild": background})
    plan = compile_link_probe(tctl.runtime)
    burst = out_of_class_burst(runtimes[0], np.random.default_rng(0))
    _tick(jctl, tctl, plan, 0, burst)
    assert _tick(jctl, tctl, plan, 1, burst).action == "rebuild"
    for th in (jctl._rebuild, tctl._rebuild):
        if th is not None and th["thread"] is not None:
            th["thread"].join(timeout=60)
            assert not th["thread"].is_alive()
    dec = _tick(jctl, tctl, plan, 2, burst)
    assert dec.action == "hot-swap" and dec.runtime_changed
    assert not tctl.runtime.entry.uses_link(frozenset(burst))
    _journals_equal(jctl, tctl, tmp_path)


def test_corruption_redoes_then_escalates(runtimes, tmp_path):
    jctl, tctl, _ = _pair(runtimes, tmp_path,
                          {"max_retries": 2, "background_rebuild": False})
    plan = compile_link_probe(tctl.runtime)
    assert _tick(jctl, tctl, plan, 0, checksum_dev=0.5).redo_step
    assert _tick(jctl, tctl, plan, 1).action == "none"
    for s in (2, 3):
        _tick(jctl, tctl, plan, s, checksum_dev=0.5)
    assert _tick(jctl, tctl, plan, 4, checksum_dev=0.5).action == "rebuild"
    assert _tick(jctl, tctl, plan, 5).action == "hot-swap"
    _journals_equal(jctl, tctl, tmp_path)


def test_node_loss_without_rescale_stalls(runtimes, tmp_path):
    jctl, tctl, _ = _pair(runtimes, tmp_path)
    plan = compile_link_probe(tctl.runtime)
    dead = _node_dead(plan)
    for s in range(3):
        dec = _tick(jctl, tctl, plan, s, dead)
        assert dec.action == "rescale" and dec.stall
    assert len(tctl.journal) == 1 and "error" in tctl.journal[0].detail
    _journals_equal(jctl, tctl, tmp_path)


def test_node_loss_checkpoints_then_rescales(runtimes, tmp_path):
    jctl, tctl, calls = _pair(runtimes, tmp_path, callbacks=True)
    plan = compile_link_probe(tctl.runtime)
    dec = _tick(jctl, tctl, plan, 0, _node_dead(plan))
    assert dec.action == "rescale" and dec.runtime_changed
    assert calls == [("ref", "ckpt"), ("ref", "rescale"), ("port", "ckpt"),
                     ("port", "rescale")]
    assert tctl.runtime.graph.n == 15
    _journals_equal(jctl, tctl, tmp_path)


def test_full_scenario_replays(runtimes, tmp_path):
    jctl, tctl, _ = _pair(runtimes, tmp_path, {"background_rebuild": False})
    plan = compile_link_probe(tctl.runtime)
    edge = _edge(tctl.runtime)
    _tick(jctl, tctl, plan, 0, {edge})
    _tick(jctl, tctl, plan, 1)
    _tick(jctl, tctl, plan, 2, {edge})
    _tick(jctl, tctl, plan, 3, {edge})
    burst = out_of_class_burst(runtimes[0], np.random.default_rng(1),
                               already_dead=frozenset({edge}))
    dead = set(burst) | {edge}
    for s in (4, 5, 6):
        _tick(jctl, tctl, plan, s, dead)
    assert [e.cause for e in tctl.journal] == ["link-flap", "link-kill",
                                               "link-burst"]
    assert tctl.generation == 1
    _journals_equal(jctl, tctl, tmp_path)


def test_load_journal_rejects_a_torn_file(tmp_path):
    path = tmp_path / "j.jsonl"
    row = {"step": 0, "cause": "straggler", "action": "observe",
           "from_schedule": 0, "to_schedule": 0, "generation": 0,
           "steps_degraded": 0, "mttr_s": 0.0, "detail": {}}
    path.write_text(json.dumps({"seq": 1, **row}) + "\n"
                    + json.dumps({"seq": 1, **row}) + "\n")
    with pytest.raises(ValueError, match="monotonic"):
        trec.load_journal(str(path))


def test_check_schedule_id_matches_reference():
    for num, sid in ((5, 0), (5, 4), (5, -1), (5, 5), (5, 99), (1, -3)):
        a, b = t_check(num, sid), j_check(num, sid)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.code, a.detail, str(a)) == (b.code, b.detail, str(b))


def test_the_clock_is_the_only_time_source(runtimes, tmp_path):
    """With the scripted clock the MTTR a kill reports is clock ticks,
    not wall time."""
    jctl, tctl, _ = _pair(runtimes, tmp_path)
    plan = compile_link_probe(tctl.runtime)
    edge = _edge(tctl.runtime)
    _tick(jctl, tctl, plan, 0, {edge})
    time.sleep(0.01)
    _tick(jctl, tctl, plan, 1, {edge})
    assert tctl.journal[-1].mttr_s == 0.25
