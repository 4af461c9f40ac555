"""The port's copies of the spec compilers against the reference's: the
fused, striped, searched (``schedule="search"``) and composed
(``schedule="composed"``) programs equal the reference's, table for
table; so do the striped bindings (``striped_tables``,
``owner_element_map``), the per-wave wire bytes of every form, the cost
model and the simulators' accounting.  Everything here is numpy; the
reference's programs are proved by its static verifier (the test
environment sets ``REPRO_VERIFY_SPECS=full``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import collectives as jcol
from repro.core import product_schedule as jps
from repro.core import schedule_search as jss
from repro.core import topologies as jtopo
from repro.core.edst_star import star_edsts as j_star_edsts
from repro.dist import tree_allreduce as jtree
from repro_torch.core import collectives as tcol
from repro_torch.core import product_schedule as tps
from repro_torch.core import schedule_search as tss
from repro_torch.core import topologies as ttopo
from repro_torch.core.edst_star import star_edsts as t_star_edsts
from repro_torch.dist import tree_allreduce as ttree

FABRICS = {
    "torus4x4": lambda t: t.device_topology((4, 4)),
    "torus2x8": lambda t: t.device_topology((2, 8)),
    "ring16": lambda t: t.device_topology((16,)),
    "hyperx4x4": lambda t: t.hyperx([4, 4]),
    "slimfly_q5": lambda t: t.slimfly(5),
}
AXES = ("a", "b")
ENGINES = ("fused", "pipelined", "striped")


def _scheds(name, roots=None):
    """(reference schedule, port schedule) of a fabric."""
    out = []
    for topo, star, col in ((jtopo, j_star_edsts, jcol),
                            (ttopo, t_star_edsts, tcol)):
        sp = FABRICS[name](topo)
        out.append(col.allreduce_schedule(sp.n, star(sp).trees, roots=roots))
    return out


def _compile(col, engine, sched, schedule="greedy"):
    fn = {"fused": col.fused_spec_from_schedule,
          "pipelined": col.pipelined_spec_from_schedule,
          "striped": col.striped_spec_from_schedule}[engine]
    return fn(sched, AXES, schedule=schedule)


def _same(a, b, what):
    """Two values, tuples of them, or numpy arrays equal (dtype too)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b), what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, (what, i))
    else:
        assert a == b, what


_WAVE_FIELDS = {
    "fused": ("perm", "send_row", "recv_row", "recv_flag"),
    "pipelined": ("perm", "send_row", "reduce_flag", "bcast_flag", "rows",
                  "sole_add"),
    "striped": ("perm", "op", "msgs", "send_tree", "send_slot", "send_nslot",
                "recv_tree", "recv_slot", "recv_nslot"),
}
_PROGRAMS = {"fused": ("reduce_rounds", "bcast_rounds"),
             "pipelined": ("waves", "q8_waves"),
             "striped": ("waves", "rs_waves", "ag_waves")}


def _spec_equal(engine, mine, ref):
    assert type(mine).__name__ == type(ref).__name__
    _same((mine.n, mine.k, mine.axes, mine.depth, mine.key),
          (ref.n, ref.k, ref.axes, ref.depth, ref.key), "header")
    if engine == "pipelined":
        assert mine.q8_boundary == ref.q8_boundary
    if engine == "striped":
        for tm, tr in zip(mine.trees, ref.trees):
            _same((tm.root, tm.pre, tm.size, tm.parent),
                  (tr.root, tr.pre, tr.size, tr.parent), "tree")
    for prog in _PROGRAMS[engine]:
        wm, wr = getattr(mine, prog), getattr(ref, prog)
        assert len(wm) == len(wr), prog
        for w, (a, b) in enumerate(zip(wm, wr)):
            for f in _WAVE_FIELDS[engine]:
                _same(getattr(a, f), getattr(b, f), (prog, w, f))


@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("schedule", ["greedy", "search"])
def test_specs_equal_reference(name, engine, schedule):
    js, ts = _scheds(name)
    ref = _compile(jcol, engine, js, schedule)
    mine = _compile(tcol, engine, ts, schedule)
    _spec_equal(engine, mine, ref)
    # cached: a recompile is the same object
    assert _compile(tcol, engine, ts, schedule) is mine


@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("engine", ENGINES)
def test_composed_specs_equal_reference(name, engine):
    ref = jps.composed_spec_for_star(FABRICS[name](jtopo), AXES,
                                     engine=engine)
    mine = tps.composed_spec_for_star(FABRICS[name](ttopo), AXES,
                                      engine=engine)
    _spec_equal(engine, mine, ref)
    js, ts = _scheds(name)
    assert _compile(tcol, engine, ts, "composed").key == \
        _compile(jcol, engine, js, "composed").key


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_searched_roots_equal_reference(name):
    js, ts = _scheds(name, roots="search")
    assert [(t.root, t.tree) for t in ts.trees] == \
        [(t.root, t.tree) for t in js.trees]
    assert tss.search_roots(ts.n, [t.tree for t in ts.trees]) == \
        jss.search_roots(js.n, [t.tree for t in js.trees])


@pytest.mark.parametrize("name", ["torus4x4", "torus2x8", "ring16"])
@pytest.mark.parametrize("size,fractions", [
    (1001, None), (64, None), (7, None), (134_515_008, None),
    (53, (0.7, 0.3)), (53, (1.0, 0.0))])
def test_striped_tables_equal_reference(name, size, fractions):
    js, ts = _scheds(name)
    ref, mine = (_compile(col, "striped", s) for col, s in ((jcol, js),
                                                            (tcol, ts)))
    if fractions is not None and ref.k != len(fractions):
        fractions = (1.0,)
    bj = jcol.striped_tables(ref, size, fractions)
    bt = tcol.striped_tables(mine, size, fractions)
    _same((bt.sizes, bt.mrow, bt.smax, bt.offsets, bt.own_off, bt.own_len),
          (bj.sizes, bj.mrow, bj.smax, bj.offsets, bj.own_off, bj.own_len),
          "binding")
    for prog in ("waves", "rs_waves", "ag_waves"):
        for w, (a, b) in enumerate(zip(getattr(bt, prog), getattr(bj, prog),
                                       strict=True)):
            for f in ("perm", "op", "wire", "send_tree", "send_off",
                      "recv_tree", "recv_off", "recv_len"):
                _same(getattr(a, f), getattr(b, f), (prog, w, f))
    if size < 10_000:
        _same(tcol.owner_element_map(mine, size, fractions),
              jcol.owner_element_map(ref, size, fractions), "owner map")


@pytest.mark.parametrize("name", ["torus4x4", "torus2x8", "ring16"])
@pytest.mark.parametrize("nbytes", [4004, 256, 538_060_032])
def test_wave_wire_bytes_and_cost_model_equal_reference(name, nbytes):
    js, ts = _scheds(name)
    pairs = [(_compile(jcol, e, js), _compile(tcol, e, ts)) for e in ENGINES]
    pairs.append((jtree.spec_from_schedule(js, AXES),
                  ttree.spec_from_schedule(ts, AXES)))
    for ref, mine in pairs:
        assert tcol.wave_wire_bytes(mine, nbytes) == \
            jcol.wave_wire_bytes(ref, nbytes)
    if js.k == 2:
        (ref, mine) = pairs[0]
        assert tcol.wave_wire_bytes(mine, nbytes, 4, (0.7, 0.3)) == \
            jcol.wave_wire_bytes(ref, nbytes, 4, (0.7, 0.3))
    (_, _), (jp, tp), (jst, tst), _ = pairs
    for backend in ("cpu", "tpu"):
        jm, tm = (col.CostModel.for_backend(backend) for col in (jcol, tcol))
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        assert tm.best_segments(nbytes, tp) == jm.best_segments(nbytes, jp)
        for s in (1, 2, 4):
            assert tm.pipelined_allreduce(nbytes, tp, s) == \
                jm.pipelined_allreduce(nbytes, jp, s)
            assert tm.wave_times(tp, nbytes, segments=s) == \
                jm.wave_times(jp, nbytes, segments=s)
        assert tm.striped_allreduce(nbytes, tst) == \
            jm.striped_allreduce(nbytes, jst)
        assert tm.edst_tree_allreduce(nbytes, ts) == \
            jm.edst_tree_allreduce(nbytes, js)
        assert tm.ring_allreduce(nbytes, 16) == jm.ring_allreduce(nbytes, 16)
    # the reference's CPU calibration never streams
    assert tcol.CostModel.for_backend("cpu").best_segments(nbytes, tp) == 1


@pytest.mark.parametrize("name", ["torus4x4", "torus2x8", "ring16"])
def test_simulators_equal_reference(name):
    js, ts = _scheds(name)
    vals = np.random.RandomState(1).randn(16, 12 * ts.k)
    mine, ref = tcol.simulate_allreduce(ts, vals), \
        jcol.simulate_allreduce(js, vals)
    assert mine.ok and ref.ok
    assert (mine.rounds, mine.max_link_load, mine.per_link_bytes) == \
        (ref.rounds, ref.max_link_load, ref.per_link_bytes)
    jst, tst = _compile(jcol, "striped", js), _compile(tcol, "striped", ts)
    for fractions in (None, (1.0 / ts.k,) * ts.k):
        mine = tcol.simulate_striped_program(tst, vals, fractions)
        ref = jcol.simulate_striped_program(jst, vals, fractions)
        assert mine.ok and mine.stripes_ok and ref.ok
        assert (mine.rounds, mine.max_link_load, mine.per_link_bytes,
                mine.wire_elems, mine.max_wire) == \
            (ref.rounds, ref.max_link_load, ref.per_link_bytes,
             ref.wire_elems, ref.max_wire)


def test_empty_specs():
    for make in ("empty_fused_spec", "empty_pipelined_spec",
                 "empty_striped_spec"):
        mine, ref = getattr(tcol, make)(16, AXES), getattr(jcol, make)(16,
                                                                        AXES)
        assert (mine.n, mine.k, mine.key) == (ref.n, ref.k, ref.key)
    with pytest.raises(ValueError):
        _compile(tcol, "fused", _scheds("ring16")[1], "annealing")
