"""The port's static wave-program verifier against the reference's: the
reports (``ok``, engine, n, k, level, message and wave counts, every
violation's code and detail) of every engine on the five paper
topologies, at both levels; the reference's mutations (one corruption
class, one named code), each applied to both packages' specs; the
compilers' build-time rejection of an illegal schedule and the recheck
of a cache hit under an explicit ``verify=``; the ``verify=`` level
resolution; and the CLI's ``--stats`` rows."""
import contextlib
import copy
import dataclasses
import io
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest

from repro.analysis import verify as jver
from repro.core import collectives as jcol
from repro.dist.tree_allreduce import spec_from_schedule as j_per_tree
from repro_torch.analysis import verify as tver
from repro_torch.core import collectives as tcol
from repro_torch.core import product_schedule as tps
from repro_torch.core import schedule_search as tss
from repro_torch.dist.tree_allreduce import spec_from_schedule as t_per_tree

JAX = SimpleNamespace(name="jax", col=jcol, ver=jver, per_tree=j_per_tree)
PORT = SimpleNamespace(name="port", col=tcol, ver=tver, per_tree=t_per_tree)
MUTATION_TOPOS = ("torus4x4", "hyperx4x4", "slimfly_q5")


@lru_cache(maxsize=None)
def sched_for(pkg_name, label):
    pkg = JAX if pkg_name == "jax" else PORT
    return pkg.ver._schedule_for(label)


def compile_spec(pkg, engine, sched, axes=("data",), verify=None):
    if engine == "per_tree":
        return pkg.per_tree(sched, axes, verify=verify)
    return getattr(pkg.col, f"{engine}_spec_from_schedule")(
        sched, axes, verify=verify)


def report_of(rep):
    return (rep.engine, rep.n, rep.k, rep.level, rep.messages, rep.waves,
            rep.ok, [(v.code, v.detail) for v in rep.violations])


def test_same_tables():
    """The constants the verifier names its violations by."""
    assert tver.ENGINES == jver.ENGINES and tver.LEVELS == jver.LEVELS
    assert tver.PAPER_TOPOLOGIES == jver.PAPER_TOPOLOGIES
    assert tver._KIND_NAME == jver._KIND_NAME


@pytest.mark.parametrize("label", tver.PAPER_TOPOLOGIES)
@pytest.mark.parametrize("engine", tver.ENGINES)
def test_reports_match_reference(label, engine):
    ref = compile_spec(JAX, engine, sched_for("jax", label))
    mine = compile_spec(PORT, engine, sched_for("port", label))
    for level in tver.LEVELS:
        got = tver.verify_spec(mine, level=level)
        assert got.ok, got.summary()
        assert report_of(got) == report_of(jver.verify_spec(ref, level))
        assert got.summary() == jver.verify_spec(ref, level).summary()
    assert tver.engine_of(mine) == jver.engine_of(ref) == engine


# ---------------------------------------------------------------------------
# the reference's mutations, each applied to both packages' specs
# ---------------------------------------------------------------------------

def mutate_drop_recv(pkg, label):
    """A receive flag silently cleared: the arrival has nowhere to land."""
    spec = copy.deepcopy(pkg.col.pipelined_spec_from_schedule(
        sched_for(pkg.name, label), ("data",)))
    _, d = spec.waves[0].perm[0]
    spec.waves[0].reduce_flag[:, d] = False
    spec.waves[0].bcast_flag[:, d] = False
    return spec, "recv-dropped"


def mutate_swap_sends(pkg, label):
    """Two senders' chunk rows swapped: arrivals land in the wrong tree."""
    spec = copy.deepcopy(pkg.col.pipelined_spec_from_schedule(
        sched_for(pkg.name, label), ("data",)))
    for wv in spec.waves:
        if len(wv.rows) >= 2:
            senders = [s for s, _ in wv.perm]
            by_row = {int(wv.send_row[s]): s for s in senders}
            rows = sorted(by_row)[:2]
            s1, s2 = by_row[rows[0]], by_row[rows[1]]
            wv.send_row[s1], wv.send_row[s2] = rows[1], rows[0]
            return spec, "row-misroute"
    raise AssertionError(f"{label}: no wave ships two distinct rows")


def mutate_double_book_link(pkg, label):
    """A whole wave replayed later: every one of its directed links is
    double-booked."""
    spec = pkg.col.pipelined_spec_from_schedule(sched_for(pkg.name, label),
                                                ("data",))
    return (dataclasses.replace(spec, waves=spec.waves + (spec.waves[0],)),
            "link-race")


def mutate_cross_wire_trees(pkg, label):
    """Two trees routed over the same physical links, built around
    ``allreduce_schedule``'s own refusal."""
    sched = sched_for(pkg.name, label)
    bad = pkg.col.AllreduceSchedule(sched.n, [sched.trees[0],
                                              sched.trees[0]])
    spec = pkg.col.pipelined_spec_from_schedule(bad, ("cross", "wire"),
                                                verify=False)
    return spec, "edge-disjointness"


def mutate_reorder_waves(pkg, label):
    """The wave order reversed: every dependency runs backwards."""
    spec = pkg.col.pipelined_spec_from_schedule(sched_for(pkg.name, label),
                                                ("data",))
    return (dataclasses.replace(spec, waves=tuple(reversed(spec.waves))),
            "happens-before")


def mutate_fused_drop_recv(pkg, label):
    spec = copy.deepcopy(pkg.col.fused_spec_from_schedule(
        sched_for(pkg.name, label), ("data",)))
    _, d = spec.reduce_rounds[0].perm[0]
    spec.reduce_rounds[0].recv_flag[d] = False
    return spec, "recv-dropped"


def mutate_stripe_window(pkg, label):
    """A stripe window widened by one slot on both endpoints."""
    spec = copy.deepcopy(pkg.col.striped_spec_from_schedule(
        sched_for(pkg.name, label), ("data",)))
    wv = spec.waves[0]
    s, d = wv.perm[0]
    wv.send_nslot[s] += 1
    wv.recv_nslot[d] += 1
    return spec, "stripe-conservation"


def mutate_striped_op(pkg, label):
    """A reduce-scatter wave's op flipped to overwrite."""
    spec = pkg.col.striped_spec_from_schedule(sched_for(pkg.name, label),
                                              ("data",))
    flipped = dataclasses.replace(
        spec.waves[0], op=pkg.col.BCAST if spec.waves[0].op == pkg.col.REDUCE
        else pkg.col.REDUCE)
    return (dataclasses.replace(spec, waves=(flipped,) + spec.waves[1:]),
            "op-mixed")


def mutate_drop_ag_wave(pkg, label):
    """The last AG-only wave dropped."""
    spec = pkg.col.striped_spec_from_schedule(sched_for(pkg.name, label),
                                              ("data",))
    return (dataclasses.replace(spec, ag_waves=spec.ag_waves[:-1]),
            "message-conservation")


def mutate_stale_ownership(pkg, label):
    """The DFS-preorder ownership table rolled one slot."""
    spec = pkg.col.striped_spec_from_schedule(sched_for(pkg.name, label),
                                              ("data",))
    st0 = spec.trees[0]
    rolled = dataclasses.replace(st0, pre=np.roll(st0.pre, 1))
    return (dataclasses.replace(spec, trees=(rolled,) + spec.trees[1:]),
            "stale-ownership")


def mutate_per_tree_bcast_dst(pkg, label):
    """A per-tree broadcast destination flag cleared (the per-tree
    engine's own scan, which the reference's mutations do not reach)."""
    spec = pkg.per_tree(sched_for(pkg.name, label), ("data",))
    tp = spec.trees[0]
    table = list(tp.bcast_dst[0])
    table[tp.bcast_rounds[0][0][1]] = False
    tp = dataclasses.replace(tp, bcast_dst=(tuple(table),)
                             + tp.bcast_dst[1:])
    return (dataclasses.replace(spec, trees=(tp,) + spec.trees[1:]),
            "recv-dropped")


MUTATIONS = {
    "drop-recv-flag": mutate_drop_recv,
    "swap-two-sends": mutate_swap_sends,
    "double-book-link": mutate_double_book_link,
    "cross-wire-trees": mutate_cross_wire_trees,
    "reorder-waves": mutate_reorder_waves,
    "fused-drop-recv": mutate_fused_drop_recv,
    "stripe-window": mutate_stripe_window,
    "striped-op-flip": mutate_striped_op,
    "drop-ag-wave": mutate_drop_ag_wave,
    "stale-ownership": mutate_stale_ownership,
    "per-tree-bcast-dst": mutate_per_tree_bcast_dst,
}


@pytest.mark.parametrize("label", MUTATION_TOPOS)
@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_reports_match_reference(name, label):
    ref, expected = MUTATIONS[name](JAX, label)
    mine, code = MUTATIONS[name](PORT, label)
    assert code == expected
    for level in tver.LEVELS:
        got = tver.verify_spec(mine, level=level)
        assert report_of(got) == report_of(jver.verify_spec(ref, level))
    got = tver.verify_spec(mine, level="full")
    assert expected in {v.code for v in got.violations}, got.summary()
    with pytest.raises(tver.SpecVerificationError) as ei:
        tver.assert_valid(mine, context="mutated")
    assert ei.value.report.violations == got.violations
    assert str(ei.value).startswith("mutated: ")


def test_violation_detail_names_the_site():
    spec, _ = mutate_drop_recv(PORT, "torus4x4")
    report = tver.verify_spec(spec, level="full")
    _, d = spec.waves[0].perm[0]
    assert any(f"vertex {d}" in v.detail for v in report.violations
               if v.code == "recv-dropped")
    assert "[recv-dropped]" in report.summary()


def test_level_is_checked_and_empty_spec_passes():
    spec = tcol.pipelined_spec_from_schedule(sched_for("port", "torus4x4"),
                                             ("data",))
    with pytest.raises(ValueError):
        tver.verify_spec(spec, level="deep")
    empty = tcol.empty_pipelined_spec(16, ("data",))
    rep = tver.verify_spec(empty)
    assert rep.ok and (rep.k, rep.messages) == (0, 0)
    with pytest.raises(TypeError):
        tver.engine_of(object())


# ---------------------------------------------------------------------------
# build-time rejection and the verify= flag
# ---------------------------------------------------------------------------

def _bad_schedule():
    sched = sched_for("port", "torus4x4")
    return tcol.AllreduceSchedule(sched.n, [sched.trees[0], sched.trees[0]])


@pytest.mark.parametrize("compiler", [
    "pipelined_spec_from_schedule", "fused_spec_from_schedule",
    "striped_spec_from_schedule", "spec_from_schedule",
    "asap_pipelined_spec", "asap_striped_spec", "search_pipelined_spec",
    "search_striped_spec", "search_fused_spec"])
def test_compile_rejects_illegal_schedule(compiler):
    """Every compiler the port has verifies a fresh spec before caching
    it: two trees over the same links are refused, naming the compiler
    (a search names the greedy compile of its incumbent, which fails
    first)."""
    fn = {"spec_from_schedule": t_per_tree}.get(compiler) or getattr(
        tps, compiler, None) or getattr(tss, compiler, None) or getattr(
        tcol, compiler)
    axes = ("rej", compiler)
    with pytest.raises(tver.SpecVerificationError) as ei:
        fn(_bad_schedule(), axes, verify=True)
    assert "edge-disjointness" in {v.code for v in
                                   ei.value.report.violations}
    named = (compiler.replace("search_", "") + "_from_schedule"
             if compiler.startswith("search_") else compiler)
    assert str(ei.value).startswith(named + ": ")


def test_compile_rejects_at_the_default_level(monkeypatch):
    """Production's default (``"cheap"``: the wave scans and the link
    race) refuses a program that double-books its links, and never
    caches it."""
    monkeypatch.delenv("REPRO_VERIFY_SPECS", raising=False)
    assert tcol._resolve_verify(None) == "cheap"
    sched = sched_for("port", "hyperx4x4")
    bad = tcol.AllreduceSchedule(sched.n, [sched.trees[0], sched.trees[0]])
    axes = ("cheap", "reject")
    key = (*tcol._sched_key(bad, axes), "pipelined")
    with pytest.raises(tver.SpecVerificationError) as ei:
        tcol.pipelined_spec_from_schedule(bad, axes)
    assert ei.value.report.level == "cheap"
    assert "link-race" in {v.code for v in ei.value.report.violations}
    assert key not in tcol._PIPE_CACHE
    spec = tcol.pipelined_spec_from_schedule(bad, axes, verify="off")
    assert tcol._PIPE_CACHE[key] is spec


def test_verify_true_rechecks_cache_hits(monkeypatch):
    """verify=True forces a full check even when the compiler returns a
    cached spec object; without it a hit is returned as it is."""
    sched = sched_for("port", "torus4x4")
    a = tcol.pipelined_spec_from_schedule(sched, ("data",))
    b = tcol.pipelined_spec_from_schedule(sched, ("data",), verify=True)
    assert a is b
    bad, _ = mutate_reorder_waves(PORT, "torus4x4")
    monkeypatch.setitem(tcol._PIPE_CACHE, a.key, bad)
    assert tcol.pipelined_spec_from_schedule(sched, ("data",)) is bad
    with pytest.raises(tver.SpecVerificationError) as ei:
        tcol.pipelined_spec_from_schedule(sched, ("data",), verify=True)
    assert "happens-before" in {v.code for v in ei.value.report.violations}


def test_verify_level_resolution(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY_SPECS", "full")
    assert tcol._resolve_verify(None) == "full"
    monkeypatch.setenv("REPRO_VERIFY_SPECS", "off")
    assert tcol._resolve_verify(None) == "off"
    assert (tcol._resolve_verify(True), tcol._resolve_verify(False)) == \
        ("full", "off")
    with pytest.raises(ValueError):
        tcol._resolve_verify("always")
    spec, _ = mutate_reorder_waves(PORT, "torus4x4")
    assert tcol.verify_compiled_spec(spec) is spec       # "off": unchecked
    # happens-before is a full-level check: the cheap scans pass it
    assert tcol.verify_compiled_spec(spec, "cheap") is spec
    with pytest.raises(tver.SpecVerificationError, match="^ctx: "):
        tcol.verify_compiled_spec(spec, "full", "ctx")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def test_stats_rows_match_reference():
    argv = ["--all-engines", "--topologies", "torus4x4", "--stats"]
    rc_t, mine = _run(tver.main, argv)
    rc_j, ref = _run(jver.main, argv)
    assert rc_t == rc_j == 0
    # every line but the closing one, which carries the elapsed time
    assert mine[:-1] == ref[:-1]
    assert any("pipelined" in ln and "861.4" in ln for ln in mine)
    sched = sched_for("port", "torus4x4")
    jsched = sched_for("jax", "torus4x4")
    for eng in tver.ENGINES:
        spec = compile_spec(PORT, eng, sched)
        ref_spec = compile_spec(JAX, eng, jsched)
        assert tver._stats_row("torus4x4", eng, spec,
                               tver.verify_spec(spec)) == \
            jver._stats_row("torus4x4", eng, ref_spec,
                            jver.verify_spec(ref_spec))


def test_cli_simulate_and_errors():
    rc, lines = _run(tver.main, ["--engines", "pipelined,striped",
                                 "--topologies", "hyperx4x4", "--simulate",
                                 "--level", "cheap"])
    assert rc == 0 and "simulate/hyperx4x4: ok" in lines
    with pytest.raises(SystemExit):
        tver.main(["--engines", "ring"])
    with pytest.raises(KeyError):
        tver._topology_case("dragonfly")
