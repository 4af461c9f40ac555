"""The port's stacked EDST engines against the reference's, run under
``shard_map`` on 16 fake host devices (one subprocess for the module, every
case written to one ``.npz``), on the same numpy payloads: the per-tree
chains (``per_tree_allreduce``, and ``run_tree_program`` with the int8
codec forced), the fused global-round engine (uniform and weighted
``fractions``, f32 and int8), the pipelined engine streamed in S = 2, 3
and 4 segments (f32 and int8), and the striped engine
(``striped_allreduce`` f32, weighted and int8, ``tree_reduce_scatter``,
``tree_allgather``, ``stripe_slices``), on the 4x4 torus and the 2x8 torus
(k=2) and the ring 16 (k=1), at payload lengths 1001 and 64.  f32 to
1e-5, compressed wires to 1e-6 or 4 ulps of the value (see the test; the
reference's ``codec="auto"`` is ``"off"`` on the CPU, so the int8 cases
force ``codec="full"`` on both sides).  Also: each engine against the
numpy packet simulators, the metrics each engine notes against the
reference's, f32 S>1 equal to S=1, and the segment policy."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import topologies as topo
from repro_torch.core.collectives import (allreduce_schedule,
                                          fused_spec_from_schedule,
                                          pipelined_spec_from_schedule,
                                          simulate_allreduce,
                                          simulate_striped_program,
                                          simulate_wave_program,
                                          striped_spec_from_schedule,
                                          striped_tables)
from repro_torch.core.edst_star import star_edsts
from repro_torch.dist import striped as S
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import StackedFabric
from repro_torch.telemetry import metrics


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors run fastest on one thread (and leave the cores to
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FABRICS = {"torus4x4": (4, 4), "torus2x8": (2, 8), "ring16": (16,)}
LENGTHS = (1001, 64)
FRACTIONS = {1: (1.0,), 2: (0.7, 0.3)}
SEGMENTS = (2, 3, 4)
# (case, compressed wire?)
CASES = (("per_tree", False), ("per_tree_q8", True), ("fused", False),
         ("fused_frac", False), ("fused_q8", True),
         *((f"pipe_s{s}", False) for s in SEGMENTS),
         *((f"pipe_s{s}_q8", True) for s in SEGMENTS),
         ("striped", False), ("striped_frac", False), ("striped_q8", True),
         ("rs", False), ("rs_q8", True), ("ag", False), ("slices", False))
# the engines whose notes the metrics test compares: (engine, quantized)
NOTED = (("per_tree", False), ("fused", False), ("fused", True),
         ("pipelined", False), ("pipelined", True), ("striped", False),
         ("striped", True))

CODE = r"""
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.core import topologies as topo
from repro.core.edst_star import star_edsts
from repro.core.collectives import (allreduce_schedule,
                                    fused_spec_from_schedule,
                                    pipelined_spec_from_schedule,
                                    striped_spec_from_schedule)
from repro.dist import striped as S
from repro.dist import tree_allreduce as T
from repro.telemetry import metrics

AX = ('a', 'b')
mesh = jax.make_mesh((4, 4), AX, axis_types=(AxisType.Auto,) * 2)


def run(body, x):
    # check_vma=False, as the reference's own train step runs its engines
    # (check_rep=False): the int8 scan's zero-initialised packed carry is
    # not typed as varying over the mesh axes, which JAX 0.9 checks
    f = jax.jit(jax.shard_map(lambda xs: body(xs.reshape(xs.shape[1:]))[None],
                              mesh=mesh, in_specs=P(AX), out_specs=P(AX),
                              check_vma=False))
    return np.asarray(f(x))


def per_tree_q8(v, tspec):
    # per_tree_allreduce's body with the int8 codec forced on every tree
    k = tspec.k
    flat = v.reshape(-1)
    pad = (-flat.size) % k
    chunks = jnp.pad(flat, (0, pad)).reshape(k, -1)
    outs = [T.run_tree_program(chunks[j], tree, tspec.n, AX, quantize=True,
                               codec='full', scope_tree=j)
            for j, tree in enumerate(tspec.trees)]
    out = jnp.concatenate(outs) if k > 1 else outs[0]
    return out[:flat.size]


def specs(dims):
    sp = topo.device_topology(dims)
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    return (T.spec_from_schedule(sched, AX),
            fused_spec_from_schedule(sched, AX),
            pipelined_spec_from_schedule(sched, AX),
            striped_spec_from_schedule(sched, AX))


out = {}
for name, dims in FABRICS.items():
    tspec, fspec, pspec, sspec = specs(dims)
    fr = FRACTIONS[pspec.k]
    for d in LENGTHS:
        x = np.random.RandomState(d).randn(16, d).astype(np.float32)
        bodies = {
            'per_tree': lambda v: T.per_tree_allreduce(v, tspec),
            'per_tree_q8': lambda v: per_tree_q8(v, tspec),
            'fused': lambda v: T.fused_tree_allreduce(v, fspec),
            'fused_frac': lambda v: T.fused_tree_allreduce(v, fspec,
                                                           fractions=fr),
            'fused_q8': lambda v: T.fused_tree_allreduce(
                v, fspec, quantize=True, codec='full'),
            'striped': lambda v: S.striped_allreduce(v, sspec),
            'striped_frac': lambda v: S.striped_allreduce(v, sspec,
                                                          fractions=fr),
            'striped_q8': lambda v: S.striped_allreduce(
                v, sspec, quantize=True, codec='full'),
            'rs': lambda v: S.tree_reduce_scatter(v, sspec),
            'rs_q8': lambda v: S.tree_reduce_scatter(v, sspec, quantize=True,
                                                     codec='full'),
            'slices': lambda v: S.stripe_slices(v, sspec),
        }
        for s in SEGMENTS:
            bodies[f'pipe_s{s}'] = lambda v, s=s: T.pipelined_tree_allreduce(
                v, pspec, segments=s)
            bodies[f'pipe_s{s}_q8'] = lambda v, s=s: \
                T.pipelined_tree_allreduce(v, pspec, quantize=True,
                                           segments=s, codec='full')
        for case, body in bodies.items():
            out[f'{name}-{d}-{case}'] = run(body, x)
        owned = out[f'{name}-{d}-rs']
        out[f'{name}-{d}-ag'] = run(
            lambda o: S.tree_allgather(o, sspec, (d,)), owned)

# the notes of one call of each engine, on the 4x4 torus at length 1001
tspec, fspec, pspec, sspec = specs(FABRICS['torus4x4'])
x = np.random.RandomState(1001).randn(16, 1001).astype(np.float32)
noted = {
    ('per_tree', False): lambda v: T.per_tree_allreduce(v, tspec),
    ('fused', False): lambda v: T.fused_tree_allreduce(v, fspec),
    ('fused', True): lambda v: T.fused_tree_allreduce(
        v, fspec, quantize=True, codec='full'),
    ('pipelined', False): lambda v: T.pipelined_tree_allreduce(
        v, pspec, segments=1),
    ('pipelined', True): lambda v: T.pipelined_tree_allreduce(
        v, pspec, quantize=True, segments=1, codec='full'),
    ('striped', False): lambda v: S.striped_allreduce(v, sspec),
    ('striped', True): lambda v: S.striped_allreduce(
        v, sspec, quantize=True, codec='full'),
}
metrics.reset()
for key in NOTED:
    run(noted[key], x)
out['metrics'] = np.array(json.dumps(metrics.snapshot()))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("engines") / "ref.npz"
    code = (f"FABRICS = {FABRICS!r}\nLENGTHS = {LENGTHS!r}\n"
            f"FRACTIONS = {FRACTIONS!r}\nSEGMENTS = {SEGMENTS!r}\n"
            f"NOTED = {NOTED!r}\nOUT = {str(path)!r}\n" + CODE)
    subproc(code, 16)
    return dict(np.load(path))


def _specs(dims):
    sp = topo.device_topology(dims)
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    return (sched, T.spec_from_schedule(sched, ("a", "b")),
            fused_spec_from_schedule(sched, ("a", "b")),
            pipelined_spec_from_schedule(sched, ("a", "b")),
            striped_spec_from_schedule(sched, ("a", "b")))


def _payload(d):
    return torch.from_numpy(np.random.RandomState(d).randn(16, d)
                            .astype(np.float32))


def per_tree_q8(x, tspec, fabric):
    """``per_tree_allreduce`` with the int8 codec forced on every tree."""
    n, k = tspec.n, tspec.k
    size = x.shape[1]
    pad = (-size) % k
    chunks = torch.nn.functional.pad(x, (0, pad)).view(n, k, -1)
    outs = [T.run_tree_program(chunks[:, j].contiguous(), tree, fabric,
                               quantize=True, codec="full", scope_tree=j)
            for j, tree in enumerate(tspec.trees)]
    out = torch.cat(outs, 1) if k > 1 else outs[0]
    return out[:, :size]


def _port(case, name, d, reference):
    _, tspec, fspec, pspec, sspec = _specs(FABRICS[name])
    fab = StackedFabric(16, "cpu")
    x = _payload(d)
    fr = FRACTIONS[pspec.k]
    if case == "per_tree":
        return T.per_tree_allreduce(x, tspec, fab)
    if case == "per_tree_q8":
        return per_tree_q8(x, tspec, fab)
    if case.startswith("fused"):
        return T.fused_tree_allreduce(
            x, fspec, fab, quantize=case == "fused_q8", codec="full",
            fractions=fr if case == "fused_frac" else None)
    if case.startswith("pipe_s"):
        s = int(case.split("_")[1][1:])
        return T.pipelined_tree_allreduce(x, pspec, fab, segments=s,
                                          quantize=case.endswith("q8"),
                                          codec="full")
    if case.startswith("striped"):
        return S.striped_allreduce(
            x, sspec, fab, quantize=case == "striped_q8", codec="full",
            fractions=fr if case == "striped_frac" else None)
    if case.startswith("rs"):
        return S.tree_reduce_scatter(x, sspec, fab, quantize=case == "rs_q8",
                                     codec="full")
    if case == "ag":
        owned = torch.from_numpy(reference[f"{name}-{d}-rs"])
        return S.tree_allgather(owned, sspec, fab, (d,))
    assert case == "slices"
    return S.stripe_slices(x, sspec, fab)


@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("d", LENGTHS)
@pytest.mark.parametrize("case,compressed", CASES,
                         ids=[c for c, _ in CASES])
def test_engine_matches_reference(reference, name, d, case, compressed):
    y = _port(case, name, d, reference)
    ref = reference[f"{name}-{d}-{case}"]
    assert tuple(y.shape) == ref.shape, (case, tuple(y.shape), ref.shape)
    diff = np.abs(y.numpy() - ref)
    if compressed:
        # 1e-6, or 4 ulps of the reference's value: XLA's CPU backend
        # contracts each int8 hop's decode and accumulate into one fused
        # multiply-add, where the port rounds the product first (as its
        # CUDA kernels, q8_unpack_rows then tree_combine, do).  A partial
        # sum then differs by an ulp, the packed total's scale by a few,
        # and every lane decoded with that scale by as many ulps of its
        # value (2 ulps measured; 1e-6 is one ulp at 8-16).
        tol = np.maximum(1e-6, 4 * np.spacing(np.abs(ref)))
    else:
        tol = 1e-5
    assert bool((diff <= tol).all()), (name, d, case, float(diff.max()))
    x = _payload(d).numpy()
    if case in ("rs", "rs_q8", "slices"):
        return
    # every vertex holds the sum; the chunk engines' vertices hold the
    # same bits (their int8 broadcast forwards one packed total), the
    # striped int8 allgather re-codes every hop (as the reference's)
    assert np.max(np.abs(y.numpy() - x.sum(0)) / (np.abs(x.sum(0)) + 1)) \
        < (0.35 if compressed else 1e-4)
    if case != "striped_q8":
        assert bool((y == y[0]).all()), (name, d, case)


@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("d", LENGTHS + (1, 5))
def test_segments_equal_one_segment_in_f32(name, d):
    """The scan runs each segment through the same adds in the same order
    as S=1, so every S gives the S=1 bits (S above the row width is capped
    at it)."""
    _, _, _, pspec, _ = _specs(FABRICS[name])
    fab = StackedFabric(16, "cpu")
    x = _payload(d)
    one = T.pipelined_tree_allreduce(x, pspec, fab, segments=1)
    for s in (2, 3, 4, 7):
        assert torch.equal(T.pipelined_tree_allreduce(x, pspec, fab,
                                                      segments=s), one), s


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_engines_against_the_simulators(name):
    """The numpy packet simulators reach the sum over every program the
    engines run, in the steps and wire widths the engines use, and the
    engines reach the same sum."""
    sched, tspec, fspec, pspec, sspec = _specs(FABRICS[name])
    fab = StackedFabric(16, "cpu")
    k = pspec.k
    vals = np.random.RandomState(3).randn(16, 40 * k).astype(np.float32)
    x = torch.from_numpy(vals)
    expect = vals.astype(np.float64).sum(0)
    flat = simulate_allreduce(sched, vals)
    assert flat.ok and flat.rounds == sched.depth * 2
    for y in (T.per_tree_allreduce(x, tspec, fab),
              T.fused_tree_allreduce(x, fspec, fab)):
        assert np.max(np.abs(y.numpy() - expect)) < 1e-4
    for s in (1, 3, 4):
        for quantized in (False, True):
            sim = simulate_wave_program(pspec, vals, s, quantized)
            waves = pspec.q8_waves if quantized else pspec.waves
            assert sim.ok and sim.rounds == len(waves) + s - 1
        y = T.pipelined_tree_allreduce(x, pspec, fab, segments=s)
        assert np.max(np.abs(y.numpy() - expect)) < 1e-4
    sim = simulate_striped_program(sspec, vals)
    bound = striped_tables(sspec, vals.shape[1])
    assert sim.ok and sim.stripes_ok and sim.rounds == len(bound.waves)
    assert sim.wire_elems == tuple(w.wire for w in bound.waves)
    assert sim.max_wire < bound.mrow
    y = S.striped_allreduce(x, sspec, fab)
    assert np.max(np.abs(y.numpy() - expect)) < 1e-4
    # the striped dispatch of simulate_wave_program
    assert simulate_wave_program(sspec, vals).ok


def test_metrics_notes_match_reference(reference):
    """One call of each engine notes the reference's program: the count of
    distinct programs, waves and static wire bytes per engine, and the
    codec selections; a repeat call of an identical program notes
    nothing more."""
    _, tspec, fspec, pspec, sspec = _specs(FABRICS["torus4x4"])
    fab = StackedFabric(16, "cpu")
    x = _payload(1001)
    calls = {
        ("per_tree", False): lambda: T.per_tree_allreduce(x, tspec, fab),
        ("fused", False): lambda: T.fused_tree_allreduce(x, fspec, fab),
        ("fused", True): lambda: T.fused_tree_allreduce(
            x, fspec, fab, quantize=True, codec="full"),
        ("pipelined", False): lambda: T.pipelined_tree_allreduce(
            x, pspec, fab, segments=1),
        ("pipelined", True): lambda: T.pipelined_tree_allreduce(
            x, pspec, fab, quantize=True, segments=1, codec="full"),
        ("striped", False): lambda: S.striped_allreduce(x, sspec, fab),
        ("striped", True): lambda: S.striped_allreduce(
            x, sspec, fab, quantize=True, codec="full"),
    }
    metrics.reset()
    try:
        for key in NOTED:
            calls[key]()
        mine = metrics.snapshot()
        for key in NOTED:       # repeats: the same programs, noted once
            calls[key]()
        assert metrics.snapshot() == mine
    finally:
        metrics.reset()
    ref = json.loads(str(reference["metrics"]))
    for name in ("edst_program_traces_total", "edst_program_waves",
                 "edst_wire_bytes", "edst_codec_selections_total"):
        assert mine[name]["values"] == ref[name]["values"], name
    assert "edst_retrace_detections_total" not in mine


def test_tree_allreduce_dispatches_on_the_spec_form():
    _, tspec, fspec, pspec, sspec = _specs(FABRICS["torus4x4"])
    fab = StackedFabric(16, "cpu")
    x = _payload(101)
    for spec, direct in ((tspec, T.per_tree_allreduce(x, tspec, fab)),
                         (fspec, T.fused_tree_allreduce(x, fspec, fab)),
                         (pspec, T.pipelined_tree_allreduce(x, pspec, fab)),
                         (sspec, S.striped_allreduce(x, sspec, fab))):
        assert torch.equal(T.tree_allreduce(x, spec, fab), direct)
    assert torch.equal(T.tree_allreduce(x, pspec, fab, segments=3),
                       T.pipelined_tree_allreduce(x, pspec, fab, segments=1))


def test_segment_policy():
    _, _, _, pspec, _ = _specs(FABRICS["torus4x4"])
    # the reference's CPU calibration never streams, nor does the cuda row
    for row in (1, 1000, 67_257_504):
        assert T.auto_segments(pspec, row, "cpu") == 1
        assert T.auto_segments(pspec, row, torch.device("cuda", 0)) == 1
    assert T.resolve_segments("auto", pspec, 50, "cpu") == 1
    assert T.resolve_segments(4, pspec, 50, "cpu") == 4
    assert T.resolve_segments(4, pspec, 3, "cpu") == 3
    with pytest.raises(ValueError):
        T.resolve_segments(0, pspec, 50, "cpu")


def test_striped_fractions_and_integers():
    _, _, _, _, sspec = _specs(FABRICS["torus4x4"])
    fab = StackedFabric(16, "cpu")
    x = _payload(53)
    for fr in ((0.7, 0.3), (1.0, 0.0)):
        y = S.striped_allreduce(x, sspec, fab, fractions=fr)
        assert float((y - x.sum(0)).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        S.striped_allreduce(x, sspec, fab, fractions=(1.0,))
    xi = torch.arange(16 * 9, dtype=torch.int64).reshape(16, 9)
    yi = S.striped_allreduce(xi, sspec, fab, quantize=True, codec="full")
    assert torch.equal(yi, xi.sum(0).expand(16, 9))


def test_reduce_scatter_partitions_the_sum():
    """The owner stripes partition the sum (``rs_conservation_gap`` ~ 0),
    ``stripe_slices`` cuts the same stripes out of a replicated array, and
    the allgather of the stripes gives back the array."""
    _, _, _, _, sspec = _specs(FABRICS["torus2x8"])
    fab = StackedFabric(16, "cpu")
    x = _payload(301)
    owned = S.tree_reduce_scatter(x, sspec, fab)
    mean = x / 16
    assert float(S.rs_conservation_gap(mean, owned / 16)) < 1e-6
    total = x.sum(0).expand(16, 301).contiguous()
    assert torch.allclose(S.stripe_slices(total, sspec, fab), owned,
                          atol=1e-5)
    back = S.tree_allgather(owned, sspec, fab, (301,))
    assert float((back - total).abs().max()) < 1e-5
    layout = S.stripe_layout(sspec, 301)
    assert sum(layout.sizes) == 301 and layout.smax == owned.shape[2]
    # a corrupted stripe shows
    broken = owned.clone()
    broken[3, 0, 0] += 100.0
    assert float(S.rs_conservation_gap(mean, broken / 16)) > 0.1
