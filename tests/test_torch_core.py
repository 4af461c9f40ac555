"""The port's own copy of the core against the reference: the same EDSTs,
the same compiled pipelined wave programs (every table, array for array,
which the reference's static verifier proves) and the same simulator
results, on the DP fabrics of the training path and the paper fabrics."""
import numpy as np
import pytest

from repro.core import collectives as jcol
from repro.core import topologies as jtopo
from repro.core.edst_star import star_edsts as j_star_edsts
from repro_torch.core import collectives as tcol
from repro_torch.core import topologies as ttopo
from repro_torch.core.edst_star import star_edsts as t_star_edsts

FABRICS = {
    "torus4x4": lambda t: t.device_topology((4, 4)),
    "ring16": lambda t: t.device_topology((16,)),
    "torus2x8": lambda t: t.device_topology((2, 8)),
    "hyperx4x4": lambda t: t.hyperx([4, 4]),
    "slimfly_q5": lambda t: t.slimfly(5),
    "polarstar_er3_qr5": lambda t: t.polarstar(3, "qr", 5),
}


def _specs(name):
    out = []
    for topo, star, col in ((jtopo, j_star_edsts, jcol),
                            (ttopo, t_star_edsts, tcol)):
        sp = FABRICS[name](topo)
        sched = col.allreduce_schedule(sp.n, star(sp).trees)
        out.append((sched, col.pipelined_spec_from_schedule(
            sched, ("a", "b"), verify="full")))
    return out


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_pipelined_tables_equal_reference(name):
    (js, jspec), (ts, tspec) = _specs(name)
    assert [(t.root, t.tree) for t in ts.trees] == \
        [(t.root, t.tree) for t in js.trees]
    assert (tspec.n, tspec.k, tspec.depth, tspec.q8_boundary) == \
        (jspec.n, jspec.k, jspec.depth, jspec.q8_boundary)
    for mine, ref in ((tspec.tables, jspec.tables),
                      (tspec.q8_tables, jspec.q8_tables)):
        assert len(mine) == len(ref) == 4
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for tw, jw in zip(tspec.q8_waves, jspec.q8_waves):
        assert (tw.perm, tw.rows, tw.sole_add) == (jw.perm, jw.rows,
                                                   jw.sole_add)


@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("quantized", [False, True])
def test_simulator_agrees_with_reference(name, quantized):
    (_, jspec), (_, tspec) = _specs(name)
    vals = np.random.RandomState(0).randn(tspec.n, 8 * tspec.k + 5)
    for segments in (1, 3):
        mine = tcol.simulate_wave_program(tspec, vals, segments, quantized)
        ref = jcol.simulate_wave_program(jspec, vals, segments, quantized)
        assert mine.ok and ref.ok
        assert (mine.rounds, mine.max_link_load, mine.per_link_bytes) == \
            (ref.rounds, ref.max_link_load, ref.per_link_bytes)


@pytest.mark.parametrize("total,fractions", [
    (1000, (0.5, 0.5)), (53, (0.7, 0.3)), (7, (1.0, 0.0)),
    (134_515_008, (0.5, 0.5)), (10, (0.2, 0.3, 0.5))])
def test_chunk_sizes_equal_reference(total, fractions):
    assert tcol.chunk_sizes(total, fractions) == \
        jcol.chunk_sizes(total, fractions)


def test_sole_add_only_on_one_tree_fabrics():
    """q8 combine hops (``sole_add``) exist only where k = 1."""
    for name in ("torus4x4", "ring16"):
        (_, _), (_, spec) = _specs(name)
        sole = [w.sole_add for w in spec.q8_waves[:spec.q8_boundary]]
        assert any(s >= 0 for s in sole) == (spec.k == 1), (name, spec.k)
