"""The port's fault detection against the reference's: the probe plan
(``program_links``, ``runtime_links``, ``compile_link_probe``) equal to
the reference's for every engine's spec and for fault runtimes; the
stacked probe's ``(L,)`` bitmap under fault masks equal to the
reference's ``mesh_link_probe`` run under ``shard_map`` on 16 fake host
devices (one subprocess for the module), with the payload checksum and
the replication divergence beside it; the straggler detector and the
report's classifications equal sample for sample; and ``HealthMonitor``
on a stacked fabric."""
import numpy as np
import pytest
import torch

from repro.core import topologies as jtopo
from repro.core.collectives import allreduce_schedule as j_sched
from repro.core.edst_star import star_edsts as j_star
from repro.dist import health as jh
from repro.dist import tree_allreduce as jtree
from repro.dist.steps import fault_runtime_for_mesh as j_runtime
from repro.core import collectives as jcol
from repro_torch.core import collectives as tcol
from repro_torch.core import topologies as ttopo
from repro_torch.core.edst_star import star_edsts as t_star
from repro_torch.dist import health as th
from repro_torch.dist import tree_allreduce as ttree
from repro_torch.dist.fabric import StackedFabric
from repro_torch.dist.steps import fault_runtime_for_mesh as t_runtime
from repro_torch.telemetry import metrics

MESHES = {"torus4x4": ((4, 4, 1), ("pod", "data", "model")),
          "ring16": ((16, 1), ("data", "model"))}
ENGINES = ("per_tree", "fused", "pipelined", "striped")
N_MASKS = 4


def _specs(col, topo, star, tree, dims):
    sp = topo.device_topology(dims)
    sched = col.allreduce_schedule(sp.n, star(sp).trees)
    axes = ("a", "b")
    return {"per_tree": tree.spec_from_schedule(sched, axes),
            "fused": col.fused_spec_from_schedule(sched, axes),
            "pipelined": col.pipelined_spec_from_schedule(sched, axes),
            "striped": col.striped_spec_from_schedule(sched, axes)}


def _plan_equal(a, b):
    assert (a.n, a.axes, a.links, a.waves) == (b.n, b.axes, b.links, b.waves)
    assert len(a.recv_src) == len(b.recv_src)
    for x, y in zip(a.recv_src + a.recv_slot, b.recv_src + b.recv_slot):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("dims", [(4, 4), (2, 8), (16,)])
def test_probe_plan_matches_reference_per_engine(dims):
    js = _specs(jcol, jtopo, j_star, jtree, dims)
    ts = _specs(tcol, ttopo, t_star, ttree, dims)
    for eng in ENGINES:
        assert th.engine_of(ts[eng]) == eng
        assert th.program_links(ts[eng]) == jh.program_links(js[eng])
        _plan_equal(th.compile_link_probe(ts[eng]),
                    jh.compile_link_probe(js[eng]))
    assert th._pack_probe_waves(th.program_links(ts["fused"])) == \
        jh._pack_probe_waves(jh.program_links(js["fused"]))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("engine", ["pipelined", "striped"])
def test_probe_plan_matches_reference_per_runtime(name, engine):
    shape, names = MESHES[name]
    jr = j_runtime(shape, names, engine=engine)
    tr = t_runtime(shape, names, engine=engine)
    assert th.runtime_links(tr) == jh.runtime_links(jr)
    _plan_equal(th.compile_link_probe(tr), jh.compile_link_probe(jr))


def _masks(L, seed):
    r = np.random.RandomState(seed)
    out = [np.ones(L, np.float32)]
    one = np.ones(L, np.float32)
    one[r.randint(L)] = 0.0
    out.append(one)
    out += [(r.rand(L) > 0.3).astype(np.float32) for _ in range(N_MASKS - 2)]
    return out


CODE = r"""
import numpy as np
import jax
from jax.sharding import AxisType, PartitionSpec as P
from repro.dist import health as H
from repro.dist.steps import fault_runtime_for_mesh

out = {}
for name, (shape, names) in MESHES.items():
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    rt = fault_runtime_for_mesh(shape, names)
    run, plan = H.mesh_link_probe(mesh, rt)
    masks = np.load(OUT + '.' + name + '.npy')
    for i, m in enumerate(masks):
        out[f'{name}/bitmap/{i}'] = np.asarray(run(m if i else None))
    dp = tuple(a for a in names if a != 'model')
    ax = dp if len(dp) > 1 else dp[0]
    x = np.load(OUT + '.x.npy')
    def body(xs):
        chk = H.payload_checksum(xs[0])
        return chk[None], H.replication_divergence(chk, ax)[None]
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(ax),
                              out_specs=(P(ax), P(ax)), check_vma=False))
    chk, dev = f(x)
    out[f'{name}/chk'] = np.asarray(chk)
    out[f'{name}/dev'] = np.asarray(dev)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("health") / "ref")
    masks = {}
    for i, (name, (shape, names)) in enumerate(sorted(MESHES.items())):
        L = th.compile_link_probe(t_runtime(shape, names)).num_links
        masks[name] = np.stack(_masks(L, i))
        np.save(f"{path}.{name}.npy", masks[name])
    x = np.random.RandomState(9).randn(16, 3, 7).astype(np.float32)
    x[5, 1, 2] += 0.25        # one replica differs
    np.save(path + ".x.npy", x)
    subproc(f"OUT = {path!r}\nMESHES = {MESHES!r}\n" + CODE, 16)
    return masks, x, dict(np.load(path + ".npz"))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_stacked_probe_matches_reference(reference, name):
    masks, _, ref = reference
    shape, names = MESHES[name]
    run, plan = th.fabric_link_probe(StackedFabric(16, "cpu"),
                                     t_runtime(shape, names))
    for i, m in enumerate(masks[name]):
        got = run(m if i else None)
        want = ref[f"{name}/bitmap/{i}"]
        assert got.dtype == np.float32 and np.array_equal(got, want), i
        if i:    # a masked link reads dead, every other one alive
            assert np.array_equal(got, m)
    assert np.all(run() == 1.0)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_checksum_and_divergence_match_reference(reference, name):
    _, x, ref = reference
    chk = th.payload_checksum(torch.from_numpy(x))
    assert np.allclose(chk.numpy(), ref[f"{name}/chk"], rtol=1e-6, atol=1e-6)
    dev = float(th.replication_divergence(chk))
    assert dev == pytest.approx(float(ref[f"{name}/dev"][0]), rel=1e-6)
    same = torch.from_numpy(np.broadcast_to(x[0], x.shape).copy())
    assert float(th.replication_divergence(th.payload_checksum(same))) == 0.0


def test_straggler_detector_matches_reference():
    r = np.random.RandomState(2)
    times = list(1.0 + 0.1 * r.rand(40))
    times[8] = times[20] = 9.0
    times[21:26] = [4.0] * 5
    j, t = jh.StragglerDetector(window=8), th.StragglerDetector(window=8)
    for dt in times:
        assert t.observe(dt) == j.observe(dt)
        assert t.baseline() == j.baseline()


def test_report_classifications_match_reference():
    rt = t_runtime(*MESHES["torus4x4"])
    plan = th.compile_link_probe(rt)
    r = np.random.RandomState(4)
    for trial in range(20):
        ok = r.rand(plan.num_links) > 0.2
        v = trial % 16
        if trial % 3 == 0:   # every link of vertex v dead: a node suspect
            ok &= np.array([v not in l for l in plan.links])
        kw = dict(step=trial, links=plan.links, link_ok=ok,
                  checksum_dev=0.01 * trial, step_time=1.0)
        a, b = th.HealthReport(**kw), jh.HealthReport(**kw)
        assert (a.all_links_ok, a.checksum_ok, a.failed_directed(),
                a.failed_edges(), a.node_suspects()) == \
            (b.all_links_ok, b.checksum_ok, b.failed_directed(),
             b.failed_edges(), b.node_suspects())


def test_health_monitor_on_a_stacked_fabric():
    rt = t_runtime(*MESHES["torus4x4"])
    metrics.reset()
    try:
        mon = th.HealthMonitor(torch.device("cpu"), rt)
        assert mon.fabric.n == 16 and mon.links == mon.plan.links
        rep = mon.check(0, step_time=1.0)
        assert rep.all_links_ok and not rep.straggler and rep.checksum_ok
        mask = np.ones(mon.plan.num_links, np.float32)
        mask[3] = 0.0
        rep = mon.check(1, fault_mask=mask, checksum_dev=0.5)
        assert rep.failed_directed() == (mon.links[3],)
        assert not rep.checksum_ok
        assert metrics.counter("edst_health_checks_total").value() == 2
        assert metrics.counter("edst_probe_failures_total").value() == 1
        assert metrics.gauge("edst_failed_links").value() == 1
        assert metrics.counter("edst_checksum_failures_total").value() == 1
        fabric = StackedFabric(16, "cpu")
        assert th.HealthMonitor(fabric, rt).fabric is fabric
    finally:
        metrics.reset()
