"""The port's chaos injector against the reference's: seeded traces of every
kind, the out-of-class bursts, and the injector's mask, time dilation,
checksum injection and fired events tick by tick, from the same seeds on
the same 4x4 torus runtime; the events counter; and, as the reference's
own chaos test does, every precompiled failure class of both engines
proven by the static verifier on the five paper topologies, with a
scripted kill session's journal replaying to the controller's state."""
import dataclasses

import numpy as np
import pytest

from repro.dist import chaos as jchaos
from repro.dist.health import compile_link_probe as j_probe
from repro.dist.steps import fault_runtime_for_mesh as j_runtime_for_mesh
from repro_torch.analysis.verify import PAPER_TOPOLOGIES, _topology_case
from repro_torch.core.edst_star import star_edsts
from repro_torch.core.fault import FailureEvent
from repro_torch.core.graph import canon
from repro_torch.dist import chaos as tchaos
from repro_torch.dist.chaos import (ChaosEvent, ChaosInjector, make_trace,
                                    out_of_class_burst, trace_summary)
from repro_torch.dist.fault import FaultAwareAllreduce
from repro_torch.dist.health import HealthReport, compile_link_probe
from repro_torch.dist.recovery import (RecoveryController, RecoveryPolicy,
                                       replay_journal)
from repro_torch.dist.steps import fault_runtime_for_mesh
from repro_torch.telemetry import metrics as tmetrics

MESH = ((16, 1), ("data", "model"))
TORUS = (4, 4)


@pytest.fixture(scope="module")
def rts():
    """(reference runtime, port runtime) of the 4x4 torus."""
    return (j_runtime_for_mesh(*MESH, dp_torus_shape=TORUS),
            fault_runtime_for_mesh(*MESH, dp_torus_shape=TORUS))


def events(trace):
    return [dataclasses.astuple(ev) for ev in trace]


def test_kinds_match_reference():
    assert tchaos.KINDS == jchaos.KINDS


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("gap", [5, 2])
def test_make_trace_matches_reference(rts, seed, gap):
    jrt, trt = rts
    mine = make_trace(trt, 48, seed=seed, kinds=tchaos.KINDS, gap=gap)
    ref = jchaos.make_trace(jrt, 48, seed=seed, kinds=jchaos.KINDS, gap=gap)
    assert events(mine) == events(ref)
    assert tuple(e.kind for e in mine) == tchaos.KINDS
    assert trace_summary(mine) == jchaos.trace_summary(ref)


def test_make_trace_is_deterministic_and_ordered(rts):
    rt = rts[1]
    kinds = tchaos.KINDS
    a = make_trace(rt, 48, seed=3, kinds=kinds)
    assert a == make_trace(rt, 48, seed=3, kinds=kinds)
    assert make_trace(rt, 48, seed=4, kinds=kinds) != a
    ticks = [e.tick for e in a]
    assert ticks == sorted(ticks) and ticks[0] >= 2
    with pytest.raises(ValueError):
        make_trace(rt, 6, kinds=("flap", "kill", "burst", "node"))
    with pytest.raises(ValueError):
        make_trace(rt, 48, kinds=("meteor",))


@pytest.mark.parametrize("seed", range(5))
def test_out_of_class_burst_matches_reference(rts, seed):
    jrt, trt = rts
    burst = out_of_class_burst(trt, np.random.default_rng(seed))
    assert burst == jchaos.out_of_class_burst(jrt,
                                              np.random.default_rng(seed))
    assert trt.valid_ids(FailureEvent(links=frozenset(burst))) == []
    assert trt.graph.without_edges(burst).is_connected()
    assert len(burst) < len(trt.graph.edges) // 2


@pytest.mark.parametrize("seed", range(3))
def test_injector_matches_reference_tick_by_tick(rts, seed):
    jrt, trt = rts
    jplan, tplan = j_probe(jrt), compile_link_probe(trt)
    assert tplan.links == jplan.links
    jinj = jchaos.ChaosInjector(
        jchaos.make_trace(jrt, 48, seed=seed, kinds=jchaos.KINDS, gap=2))
    tinj = ChaosInjector(make_trace(trt, 48, seed=seed, kinds=tchaos.KINDS,
                                    gap=2))
    for _ in range(24):
        assert events(tinj.advance()) == events(jinj.advance())
        assert tinj.tick == jinj.tick
        np.testing.assert_array_equal(tinj.fault_mask(tplan),
                                      jinj.fault_mask(jplan))
        assert tinj.time_dilation() == jinj.time_dilation()
        assert tinj.checksum_injection() == jinj.checksum_injection()
        assert (tinj.dead_edges, tinj.dead_nodes) == (jinj.dead_edges,
                                                      jinj.dead_nodes)
    assert tinj.done and jinj.done
    tinj.clear_fabric_state()
    jinj.clear_fabric_state()
    np.testing.assert_array_equal(tinj.fault_mask(tplan),
                                  jinj.fault_mask(jplan))


def test_injector_masks_expires_and_clears(rts):
    rt = rts[1]
    plan = compile_link_probe(rt)
    edge = canon(*plan.links[0])
    v = plan.links[-1][1]
    trace = (ChaosEvent(tick=1, kind="flap", links=(edge,), duration=1),
             ChaosEvent(tick=3, kind="kill", links=(edge,)),
             ChaosEvent(tick=5, kind="corruption", duration=1,
                        magnitude=1.0),
             ChaosEvent(tick=7, kind="straggler", duration=2,
                        magnitude=4.0),
             ChaosEvent(tick=10, kind="node", node=v))
    inj = ChaosInjector(trace)
    slots = [i for i, l in enumerate(plan.links) if canon(*l) == edge]
    nslots = [i for i, l in enumerate(plan.links) if v in l]

    def mask():
        return inj.fault_mask(plan)

    inj.advance()                                  # tick 0: healthy
    assert mask().all() and inj.time_dilation() == 1.0
    assert inj.checksum_injection() == 0.0
    inj.advance()                                  # tick 1: flap fires
    assert not mask()[slots].any() and mask().sum() == len(mask()) - 2
    inj.advance()                                  # tick 2: flap expired
    assert mask().all()
    inj.advance()                                  # tick 3: permanent kill
    assert not mask()[slots].any()
    inj.advance()                                  # tick 4: still dead
    assert not mask()[slots].any()
    inj.advance()                                  # tick 5: corruption
    assert inj.checksum_injection() == 1.0
    inj.advance()                                  # tick 6: expired
    assert inj.checksum_injection() == 0.0
    inj.advance()                                  # tick 7: straggler on
    assert inj.time_dilation() == 4.0
    inj.advance()                                  # tick 8: still on
    assert inj.time_dilation() == 4.0
    inj.advance()                                  # tick 9: expired
    assert inj.time_dilation() == 1.0
    inj.advance()                                  # tick 10: node loss
    assert not mask()[nslots].any()
    inj.clear_fabric_state()                       # post-rescale reset
    assert mask().all()
    assert inj.done


def test_events_counter_counts(rts):
    before = tmetrics.counter_values("edst_chaos_events_total")
    inj = ChaosInjector(make_trace(rts[1], 48, seed=0, kinds=tchaos.KINDS,
                                   gap=2))
    while not inj.done:
        inj.advance()
    after = tmetrics.counter_values("edst_chaos_events_total")
    for kind in tchaos.KINDS:
        key = (("kind", kind),)
        assert after[key] - before.get(key, 0.0) == 1.0, kind


def _scripted_kill_session(runtime):
    """Confirm a tree-link kill through the controller; return it."""
    plan = compile_link_probe(runtime)
    ctrl = RecoveryController(
        runtime, RecoveryPolicy(background_rebuild=False))
    edge = next(iter(sorted(runtime.entries[0].sched.trees[0].tree)))
    dead = frozenset({edge})
    ok = np.array([canon(s, d) not in dead for s, d in plan.links])
    for step in (0, 1):
        ctrl.observe(HealthReport(step=step, links=plan.links, link_ok=ok))
    return ctrl


@pytest.mark.parametrize("label", PAPER_TOPOLOGIES)
def test_every_failure_class_verifies_statically(label):
    """On each paper topology, both engines' full precompiled entry tables
    (full + degraded + rebuilt per tree) pass the static verifier, and a
    scripted kill session's journal replays to the same final schedule
    id the controller holds."""
    sp, es = _topology_case(label)
    res = star_edsts(sp, Es=es) if es is not None else star_edsts(sp)
    g = sp.product()
    for engine in ("pipelined", "striped"):
        rt = FaultAwareAllreduce.build(g, res.trees, ("data",),
                                       engine=engine)
        assert len(rt.entries) == 2 * rt.k + 1
        for i, e in enumerate(rt.entries):
            if e.sched is None:        # k=0 stub on a k=1 fabric
                assert not rt.verify_entry(i, static=True)
                continue
            assert rt.verify_entry(i, static=True), (label, engine, e.name)
        ctrl = _scripted_kill_session(rt)
        assert ctrl.journal, (label, engine)
        assert replay_journal(ctrl.journal) == (ctrl.generation,
                                                ctrl.schedule_id)
