"""The port's fault runtime against the reference's: the core fault helpers
(``FailureEvent``, ``surviving_trees``, ``rebuild_edsts``,
``FaultTolerantAllreduce``, ``rebalance_chunks``) and
``FaultAwareAllreduce``'s entries, compared table for table (names,
fractions, schedules, specs), its ``valid_ids`` and ``on_failure`` picks
for every single-link failure, ``with_rebuild``, the zero1 element maps
and ``owned_permutation``, on the 4x4 and 2x8 tori and the ring 16.  Each
entry's allreduce is held against the reference's ``make_allreduce`` run
under ``shard_map`` on 16 fake host devices (one subprocess for the
module): f32 to 1e-5, the int8 wire (``codec="full"`` on both sides, the
reference's ``"auto"`` is ``"off"`` on the CPU) to 1e-6 or 4 ulps of the
value, but for the ring's one tipped column (exactly one quantization step,
see ``TIPPED_RING_COLUMNS``); with the port's int8 hop rounded once, as
the reference's FMA, every int8 entry equals the reference's bit for bit.
A schedule id outside the entry table, negative ones included, raises."""
import numpy as np
import pytest
import torch

from repro.core import fault as jcf
from repro.core import topologies as jtopo
from repro.core.collectives import allreduce_schedule as j_sched
from repro.core.edst_star import star_edsts as j_star
from repro.dist import fault as jfault
from repro.dist.steps import fault_runtime_for_mesh as j_runtime_for_mesh
from repro_torch.core import fault as tcf
from repro_torch.core import topologies as ttopo
from repro_torch.core.collectives import allreduce_schedule as t_sched
from repro_torch.core.edst_star import star_edsts as t_star
from repro_torch.core.graph import canon
from repro_torch.dist import fault as tfault
from repro_torch.dist import tree_allreduce
from repro_torch.dist.fabric import StackedFabric
from repro_torch.dist.steps import fault_runtime_for_mesh as t_runtime_for_mesh
from test_torch_schedules import _same, _spec_equal


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fabric -> (mesh shape, axis names): the DP axes span the fabric
MESHES = {"torus4x4": ((4, 4, 1), ("pod", "data", "model")),
          "torus2x8": ((2, 8, 1), ("pod", "data", "model")),
          "ring16": ((16, 1), ("data", "model"))}
DIMS = {"torus4x4": (4, 4), "torus2x8": (2, 8), "ring16": (16,)}
# (fabric, engine, quantized) cases of the allreduce oracle
CASES = (("torus4x4", "pipelined", False), ("torus4x4", "striped", False),
         ("torus4x4", "pipelined", True), ("torus2x8", "pipelined", False),
         ("ring16", "pipelined", False), ("ring16", "pipelined", True))
LENGTH = 1001

_RUNTIMES: dict = {}


def runtimes(name, engine="pipelined"):
    """(reference runtime, port runtime) of a fabric, built once."""
    key = (name, engine)
    if key not in _RUNTIMES:
        shape, names = MESHES[name]
        _RUNTIMES[key] = (j_runtime_for_mesh(shape, names, engine=engine),
                          t_runtime_for_mesh(shape, names, engine=engine))
    return _RUNTIMES[key]


def _sched_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is None:
        return
    _same(a.n, b.n, what)
    assert len(a.trees) == len(b.trees), what
    for ta, tb in zip(a.trees, b.trees):
        assert ta.tree == tb.tree and ta.root == tb.root, what
        _same((ta.reduce_rounds, ta.bcast_rounds),
              (tb.reduce_rounds, tb.bcast_rounds), what)


# ---------------------------------------------------------------------------
# core/fault.py
# ---------------------------------------------------------------------------

def _core(name, topo, star, sched):
    sp = topo.device_topology(DIMS[name])
    g = sp.product()
    return g, sched(g.n, star(sp).trees)


@pytest.mark.parametrize("name", sorted(DIMS))
def test_core_fault_helpers_match_reference(name):
    jg, js = _core(name, jtopo, j_star, j_sched)
    tg, ts = _core(name, ttopo, t_star, t_sched)
    trees = [t.tree for t in ts.trees]
    edge = sorted(trees[0])[0]
    node = 5
    for ev in ({"links": frozenset({edge})}, {"nodes": frozenset({node})},
               {"links": frozenset({edge}), "nodes": frozenset({node})}):
        jd = jcf.FailureEvent(**ev).dead_links(jg)
        td = tcf.FailureEvent(**ev).dead_links(tg)
        assert jd == td
        assert jcf.surviving_trees([t.tree for t in js.trees], jd) == \
            tcf.surviving_trees(trees, td)
    jt, jr = jcf.rebuild_edsts(jg, {edge})
    tt, tr = tcf.rebuild_edsts(tg, {edge})
    assert jt == tt and jr.edges == tr.edges
    # degrade on a link, rebuild, and a node loss's eager repack
    for ev in ({"links": frozenset({edge})}, {"nodes": frozenset({node})}):
        try:
            jm = jcf.FaultTolerantAllreduce(jg, js).on_failure(
                jcf.FailureEvent(**ev))
        except RuntimeError as exc:   # the ring's one tree lost
            with pytest.raises(RuntimeError, match=str(exc)):
                tcf.FaultTolerantAllreduce(tg, ts).on_failure(
                    tcf.FailureEvent(**ev))
            continue
        tm = tcf.FaultTolerantAllreduce(tg, ts).on_failure(
            tcf.FailureEvent(**ev))
        assert jm.history == tm.history and jm.graph.edges == tm.graph.edges
        _sched_equal(jm.schedule, tm.schedule, (name, ev))
        jb, tb = jm.rebuild(), tm.rebuild()
        assert jb.history == tb.history
        _sched_equal(jb.schedule, tb.schedule, (name, ev, "rebuild"))
    delays = {0: 3.0, 7: 1.5, 11: 9.0}
    assert jcf.rebalance_chunks(js, delays) == tcf.rebalance_chunks(ts, delays)
    assert jcf.rebalance_chunks(js, {}) == tcf.rebalance_chunks(ts, {})


# ---------------------------------------------------------------------------
# the runtime's tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("engine", ["pipelined", "striped"])
def test_runtime_entries_match_reference(name, engine):
    jr, tr = runtimes(name, engine)
    assert (tr.graph.n, tr.axes, tr.engine, tr.k, tr.active) == \
        (jr.graph.n, jr.axes, jr.engine, jr.k, jr.active)
    assert tr.graph.edges == jr.graph.edges
    assert [e.name for e in tr.entries] == [e.name for e in jr.entries]
    for i, (te, je) in enumerate(zip(tr.entries, jr.entries)):
        assert te.fractions == je.fractions, (name, i)
        assert (te.k, te.depth) == (je.k, je.depth), (name, i)
        _sched_equal(je.sched, te.sched, (name, i))
        _spec_equal(engine, te.spec, je.spec)
    assert tr.report() == jr.report()
    for i in range(len(tr.entries)):
        assert tr.verify_entry(i) == jr.verify_entry(i)
        assert tr.effective_bandwidth(1 << 20, i) == \
            jr.effective_bandwidth(1 << 20, i)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_failure_picks_match_reference(name):
    """valid_ids and on_failure's pick for every single link of the
    fabric, under both preferences, and a link of every tree at once."""
    jr, tr = runtimes(name)
    for edge in sorted(tr.graph.edges):
        jev = jcf.FailureEvent(links=frozenset({edge}))
        tev = tcf.FailureEvent(links=frozenset({edge}))
        assert tr.valid_ids(tev) == jr.valid_ids(jev), edge
        for prefer in ("max_k", "degraded"):
            try:
                want = jr.on_failure(jev, prefer=prefer)
            except jfault.NoScheduleError:
                with pytest.raises(tfault.NoScheduleError):
                    tr.on_failure(tev, prefer=prefer)
                continue
            got = tr.on_failure(tev, prefer=prefer)
            assert (got.active, got.history) == (want.active, want.history)
            assert got._reshard_cache is tr._reshard_cache
    burst = frozenset(sorted(t.tree)[0] for t in tr.entries[0].sched.trees)
    if tr.k > 1:
        with pytest.raises(tfault.NoScheduleError):
            tr.on_failure(tcf.FailureEvent(links=burst))
        got = tr.with_rebuild(tcf.FailureEvent(links=burst))
        want = jr.with_rebuild(jcf.FailureEvent(links=burst))
        assert [e.name for e in got.entries] == [e.name for e in want.entries]
        for te, je in zip(got.entries, want.entries):
            assert te.fractions == je.fractions
            _sched_equal(je.sched, te.sched, "with_rebuild")
        assert got.history == want.history
    for bad in ({"nodes": frozenset({3})},):
        with pytest.raises(tfault.NoScheduleError):
            tr.on_failure(tcf.FailureEvent(**bad))
        with pytest.raises(tfault.NoScheduleError):
            tr.with_rebuild(tcf.FailureEvent(**bad))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("size", [53, 1001, 7])
def test_zero1_maps_and_permutations_match_reference(name, size):
    jr, tr = runtimes(name, "striped")
    assert tr.zero1_geometry(size) == jr.zero1_geometry(size)
    ids = range(len(tr.entries))
    for i in ids:
        _same(tr.zero1_element_map(size, i), jr.zero1_element_map(size, i),
              (name, size, i))
    for a in ids:
        for b in ids:
            _same(tr.owned_permutation(a, b, size),
                  jr.owned_permutation(a, b, size), (name, size, a, b))


def test_pipelined_runtime_refuses_zero1():
    _, tr = runtimes("torus4x4")
    with pytest.raises(ValueError, match="striped"):
        tr.make_zero1_sync()
    with pytest.raises(ValueError, match="striped"):
        tr.reshard_owned(torch.zeros(16, 2, 3), 0, 1, 53)


@pytest.mark.parametrize("bad", [-1, -5, 5, 99])
def test_schedule_id_out_of_range_raises(bad):
    """``entries[-1]`` would run the last class without a word; every
    entry point that takes an id refuses it instead."""
    _, tr = runtimes("torus4x4", "striped")
    fabric = StackedFabric(16, "cpu")
    x = torch.zeros(16, 40)
    allreduce = tr.make_allreduce()
    rs, sl, ag = tr.make_zero1_sync()
    state = torch.zeros(16, *tr.zero1_geometry(40))
    calls = (lambda: allreduce(x, bad, fabric),
             lambda: rs(x, bad, fabric), lambda: sl(x[0], bad),
             lambda: ag(state, bad, (40,), fabric),
             lambda: tr.reshard_owned(state, 0, bad, 40),
             lambda: tr.zero1_element_map(40, bad))
    for call in calls:
        with pytest.raises(ValueError, match="sid-out-of-range"):
            call()
    assert allreduce(x, 4, fabric).shape == x.shape   # the last id runs


def test_reshard_owned_round_trips_and_caches():
    """reshard_owned is a permutation: there and back gives the state bit
    for bit; the gather index is built once per (from, to, size)."""
    _, tr = runtimes("torus4x4", "striped")
    size = 1001
    kmax, smax = tr.zero1_geometry(size)
    live = torch.from_numpy(tr.zero1_element_map(size, 0) >= 0)
    mu = torch.randn(16, kmax, smax) * live
    there = tr.reshard_owned(mu, 0, 1, size)
    back = tr.reshard_owned(there, 1, 0, size)
    assert torch.equal(back, mu)
    perm = tr.owned_permutation(0, 1, size)
    flat = mu.reshape(-1).numpy()
    want = np.where(perm >= 0, flat[np.clip(perm, 0, None)], 0.0)
    assert np.array_equal(there.numpy(), want)
    cached = len(tr._reshard_cache)
    tr.reshard_owned(mu, 0, 1, size)
    assert len(tr._reshard_cache) == cached


# ---------------------------------------------------------------------------
# each entry's allreduce against the reference's, under shard_map
# ---------------------------------------------------------------------------

CODE = r"""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.dist import tree_allreduce as T
from repro.dist.steps import fault_runtime_for_mesh

out = {}
for name, engine, q in CASES:
    shape, names = MESHES[name]
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    rt = fault_runtime_for_mesh(shape, names, engine=engine)
    dp = tuple(a for a in names if a != 'model')
    spec_in = P(dp if len(dp) > 1 else dp[0])
    x = np.load(OUT + '.in.npy')
    allreduce = rt.make_allreduce()
    for i, e in enumerate(rt.entries):
        if q:
            if e.k == 0:
                continue
            fn = lambda xs, sid, e=e: T.pipelined_tree_allreduce(
                xs.reshape(xs.shape[1:]), e.spec, True, segments=1,
                fractions=e.fractions, codec='full')[None]
        else:
            fn = lambda xs, sid: allreduce(xs.reshape(xs.shape[1:]), sid)[None]
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec_in, P()),
                                  out_specs=spec_in, check_vma=False))
        out[f'{name}/{engine}/{int(q)}/{i}'] = np.asarray(
            f(x, jnp.int32(i)))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference_allreduces(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("fault") / "ref.npz"
    x = np.random.RandomState(3).randn(16, LENGTH).astype(np.float32)
    np.save(str(path) + ".in.npy", x)
    subproc(f"OUT = {str(path)!r}\nCASES = {CASES!r}\n"
            f"MESHES = {MESHES!r}\n" + CODE, 16)
    return x, dict(np.load(path))


def _within(got, want, q):
    """f32 to 1e-5; int8 to 1e-6 or 4 ulps of the value (XLA's CPU backend
    decodes and accumulates an int8 hop in one FMA, the port in two
    roundings)."""
    if not q:
        assert np.max(np.abs(got - want)) <= 1e-5 * max(1.0, np.abs(want).max())
        return
    ulp = np.spacing(np.abs(want).astype(np.float32))
    off = np.abs(got - want)
    assert np.all((off <= 1e-6) | (off <= 4 * ulp)), float(off.max())


# On the ring's one tree every int8 hop re-quantizes the chain's partial
# sum, 15 hops deep.  The FMA ulp of one hop can carry a column across the
# next hop's rounding boundary; that column then reaches the root one
# quantization step off, and the root's pack-once broadcast carries it to
# every row.  Seen at one column of 1001 (seed 3, column 469);
# test_int8_entries_equal_the_reference_with_one_rounding_hops shows that
# rounding the port's hop once removes it.
TIPPED_RING_COLUMNS = 1


def _tipped_columns(got, want):
    """Columns of a one-chunk (k = 1) int8 result that lie exactly one
    quantization step of the broadcast scale off; no other column may
    differ by more than 4 ulps."""
    ulp = np.spacing(np.abs(want).astype(np.float32))
    off = np.abs(got - want)
    cols = np.nonzero(~((off <= 1e-6) | (off <= 4 * ulp)).all(0))[0]
    # the root's one chunk: its largest element packs to 127
    step = np.abs(want).max(1, keepdims=True) / 127
    assert np.all(np.abs(off[:, cols] - step) <= 2 * ulp[:, cols]), \
        (cols.tolist(), off[:, cols].max(), float(step.max()))
    return cols


def _entries(name, engine, q, ref, x):
    """``(entry, port result, reference result)`` of every entry the
    reference ran."""
    _, tr = runtimes(name, engine)
    fabric = StackedFabric(16, "cpu")
    allreduce = tr.make_allreduce(quantize=q, segments=1,
                                  codec="full" if q else None)
    out = []
    for i, e in enumerate(tr.entries):
        key = f"{name}/{engine}/{int(q)}/{i}"
        if key not in ref:
            assert q and e.k == 0
            continue
        out.append((e, allreduce(torch.from_numpy(x), i, fabric).numpy(),
                    ref[key]))
    assert len(out) == sum(1 for e in tr.entries if e.k or not q)
    return out


@pytest.mark.parametrize("name,engine,q", CASES)
def test_entry_allreduces_match_reference(reference_allreduces, name,
                                          engine, q):
    x, ref = reference_allreduces
    for e, got, want in _entries(name, engine, q, ref, x):
        if q and name == "ring16":
            assert e.k == 1 and len(e.fractions) == 1
            cols = _tipped_columns(got, want)
            assert len(cols) <= TIPPED_RING_COLUMNS, cols.tolist()
            got, want = np.delete(got, cols, 1), np.delete(want, cols, 1)
        _within(got, want, q)
        if e.k and not q:
            _within(got, np.broadcast_to(x.sum(0), x.shape), False)


def _one_rounding_combine(wires, partial):
    """``partial + q * scale`` rounded to f32 once, as an FMA rounds it
    (float64 holds the int8-by-f32 product exactly)."""
    scale = wires[:, -4:].contiguous().view(torch.float32).double()
    return (partial.double() + wires[:, :-4].double() * scale).float()


@pytest.mark.parametrize("name,engine,q", [c for c in CASES if c[2]])
def test_int8_entries_equal_the_reference_with_one_rounding_hops(
        reference_allreduces, monkeypatch, name, engine, q):
    """The cause of the int8 differences: with the port's single-arrival
    hop (``q8_combine_rows``, every k = 1 entry) rounded once, as the
    reference's fused FMA, every int8 entry equals the reference bit for
    bit, the ring's tipped column included."""
    x, ref = reference_allreduces
    monkeypatch.setattr(tree_allreduce, "q8_combine_rows",
                        _one_rounding_combine)
    for e, got, want in _entries(name, engine, q, ref, x):
        assert np.array_equal(got, want), (e.name, np.abs(got - want).max())
