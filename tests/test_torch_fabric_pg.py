"""The process-group fabric (``repro_torch.dist.fabric.ProcessGroupFabric``)
against the stacked one, over gloo on the CPU.

One spawn of 4 ranks (``torch.multiprocessing``, a ``file://`` store under
the test's temporary directory, each rank joined with its own timeout)
runs every engine -- per-tree, fused, pipelined at S = 1 and S = 4,
striped allreduce, reduce-scatter and allgather -- in f32 and over the
int8 wire (``codec="full"``, the plain codec) on the five paper
topologies (16, 16, 50, 65 and 160 vertices: blocks such as 13/13/12/12),
the ring 16 and the 2x2 torus (one vertex a rank).  Every rank's rows must
equal the stacked run of this process on the same numpy payload, bit for
bit.  The same ranks check ``ppermute``'s exact zeros, ``psum`` and
``axis_index``, a world-1 subgroup against the stacked fabric, and the
refusal of a tensor the group's backend does not carry.
"""
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from repro_torch.analysis.verify import PAPER_TOPOLOGIES, _schedule_for
from repro_torch.core import topologies as topo
from repro_torch.core.collectives import (allreduce_schedule,
                                          fused_spec_from_schedule,
                                          pipelined_spec_from_schedule,
                                          striped_spec_from_schedule)
from repro_torch.core.edst_star import star_edsts
from repro_torch.dist import striped as S
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import (ProcessGroupFabric, StackedFabric,
                                     vertex_blocks)

WORLD = 4
JOIN_S = 120
LENGTH = 53
LABELS = PAPER_TOPOLOGIES + ("ring16", "torus2x2")
ENGINES = ("per_tree", "fused", "pipe_s1", "pipe_s4", "striped", "rs", "ag")
DTYPES = ("f32", "int8")
# a partial permutation of the 16 vertices: 1 and 7 send nowhere, 2, 4,
# 6 and 9-15 receive nothing
PERM = ((0, 5), (5, 8), (8, 0), (3, 1), (1, 3), (7, 7))


def _schedule(label):
    if label == "ring16":
        sp = topo.device_topology((16,))
    elif label == "torus2x2":
        sp = topo.device_topology((2, 2))
    else:
        return _schedule_for(label)
    return allreduce_schedule(sp.n, star_edsts(sp).trees)


def _specs(label):
    sched = _schedule(label)
    axes = ("data",)
    return {"per_tree": T.spec_from_schedule(sched, axes),
            "fused": fused_spec_from_schedule(sched, axes),
            "pipelined": pipelined_spec_from_schedule(sched, axes),
            "striped": striped_spec_from_schedule(sched, axes)}


def _payload(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, LENGTH)).astype(np.float32)


def _run(engine, x, specs, fabric, quantize):
    """One engine on the fabric's rows ``x``; int8 through the plain codec
    (``codec="full"``; the per-tree engine's own codec is "off" on the
    CPU, so its trees run through ``run_tree_program`` at "full", chunked
    as the engine chunks)."""
    codec = "full" if quantize else "off"
    if engine == "per_tree":
        spec = specs["per_tree"]
        if not quantize:
            return T.per_tree_allreduce(x, spec, fabric)
        chunks = F.pad(x, (0, -x.shape[1] % spec.k)).view(
            x.shape[0], spec.k, -1)
        return torch.cat([T.run_tree_program(chunks[:, j].contiguous(), tree,
                                             fabric, True, codec=codec)
                          for j, tree in enumerate(spec.trees)],
                         1)[:, :x.shape[1]]
    if engine == "fused":
        return T.fused_tree_allreduce(x, specs["fused"], fabric, quantize,
                                      codec=codec)
    if engine.startswith("pipe"):
        return T.pipelined_tree_allreduce(
            x, specs["pipelined"], fabric, quantize, codec=codec,
            segments=int(engine[-1]))
    spec = specs["striped"]
    if engine == "striped":
        return S.striped_allreduce(x, spec, fabric, quantize, codec=codec)
    owned = S.tree_reduce_scatter(x, spec, fabric, quantize=quantize,
                                  codec=codec)
    if engine == "rs":
        return owned
    return S.tree_allgather(owned, spec, fabric, (x.shape[1],),
                            quantize=quantize, codec=codec)


def _all_engines(x, specs, fabric):
    return {(engine, dt): _run(engine, x, specs, fabric, dt == "int8")
            for engine in ENGINES for dt in DTYPES}


def _rank_main(rank, world, init, out_dir):
    """One gloo rank: every case's local rows, written to
    ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = {}
        for i, label in enumerate(LABELS):
            specs = _specs(label)
            n = specs["pipelined"].n
            fabric = ProcessGroupFabric(n, "cpu")
            x = torch.from_numpy(_payload(n, i))[fabric.lo:fabric.hi]
            for key, y in _all_engines(x, specs, fabric).items():
                out[(label,) + key] = y
            out[(label, "blocks")] = (fabric.lo, fabric.hi)
        fabric = ProcessGroupFabric(16, "cpu")
        x = torch.from_numpy(_payload(16, 99))[fabric.lo:fabric.hi]
        out["ppermute"] = fabric.ppermute(x + 1.0, PERM)
        out["psum"] = fabric.psum(x).clone()
        out["axis_index"] = fabric.axis_index()
        # a world-1 group of this rank alone: the stacked fabric, bit for
        # bit (every rank takes part in creating every subgroup)
        mine = [dist.new_group([r]) for r in range(world)][rank]
        specs = _specs("torus4x4")
        one = ProcessGroupFabric(16, "cpu", group=mine)
        out["world1"] = _all_engines(torch.from_numpy(_payload(16, 7)),
                                     specs, one)
        refused = []
        for bad in (lambda: ProcessGroupFabric(16, "meta"),
                    lambda: fabric.ppermute(
                        torch.zeros(fabric.rows, 3, device="meta"), PERM),
                    lambda: fabric.psum(
                        torch.zeros(fabric.rows, device="meta"))):
            try:
                bad()
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@contextmanager
def one_thread():
    """This process's CPU ops on one thread, as each rank runs them: a
    reduction split over threads could round otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def spawn_ranks(tmp_path, target, world=WORLD, args=()):
    """Run ``target(rank, world, init, out_dir, *args)`` on ``world`` spawned
    ranks sharing a ``file://`` store under ``tmp_path``; each is joined
    with its own timeout, so a hang fails instead of stalling the suite.
    Returns each rank's ``rank{r}.pt``."""
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=target,
                         args=(r, world, init, str(tmp_path), *args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("fabric_pg"), _rank_main)


@pytest.fixture(scope="module")
def stacked():
    """Every case on the stacked fabric of this process."""
    out = {}
    with one_thread():
        for i, label in enumerate(LABELS):
            specs = _specs(label)
            n = specs["pipelined"].n
            x = torch.from_numpy(_payload(n, i))
            fabric = StackedFabric(n, "cpu")
            for key, y in _all_engines(x, specs, fabric).items():
                out[(label,) + key] = y
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("label", LABELS)
def test_rank_rows_equal_stacked(ranks, stacked, label, engine, dtype):
    want = stacked[(label, engine, dtype)]
    assert torch.isfinite(want).all()
    rows = 0
    for r, got in enumerate(ranks):
        lo, hi = got[(label, "blocks")]
        y = got[(label, engine, dtype)]
        assert y.shape == want[lo:hi].shape, (r, y.shape)
        assert torch.equal(y, want[lo:hi]), (r, float((y - want[lo:hi])
                                                      .abs().max()))
        rows += hi - lo
    assert rows == want.shape[0]


@pytest.mark.parametrize("label", LABELS)
def test_blocks_differ_by_at_most_one(ranks, label):
    n = _specs(label)["pipelined"].n
    blocks = [got[(label, "blocks")] for got in ranks]
    assert blocks == vertex_blocks(n, WORLD)
    sizes = [hi - lo for lo, hi in blocks]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == n
    if label == "torus2x2":
        assert sizes == [1] * WORLD     # the reference's shard_map layout


def test_vertex_blocks_refuse_more_ranks_than_vertices():
    assert vertex_blocks(50, 4) == [(0, 13), (13, 26), (26, 38), (38, 50)]
    with pytest.raises(ValueError, match="world size 5"):
        vertex_blocks(4, 5)


def test_ppermute_unsent_rows_are_exact_zeros(ranks):
    x = torch.from_numpy(_payload(16, 99)) + 1.0
    got = torch.cat([r["ppermute"] for r in ranks])
    want = StackedFabric(16, "cpu").ppermute(x, PERM)
    assert torch.equal(got, want)
    received = {d for _, d in PERM}
    for v in range(16):
        if v in received:
            s = next(s for s, d in PERM if d == v)
            assert torch.equal(got[v], x[s])
        else:
            assert not got[v].any(), v        # +0.0 everywhere
            assert not torch.signbit(got[v]).any(), v


def test_psum_and_axis_index_equal_stacked(ranks):
    x = torch.from_numpy(_payload(16, 99))
    fab = StackedFabric(16, "cpu")
    for got in ranks:
        lo = int(got["axis_index"][0])
        assert got["axis_index"].tolist() == list(
            range(lo, lo + got["psum"].shape[0]))
        # every local row holds the sum over all 16 vertices (four
        # partial sums: equal to the stacked sum within f32 rounding)
        for row in got["psum"]:
            torch.testing.assert_close(row, fab.psum(x)[0], rtol=0,
                                       atol=1e-5)


def test_world1_group_is_the_stacked_fabric(ranks, stacked):
    specs = _specs("torus4x4")
    want = _all_engines(torch.from_numpy(_payload(16, 7)), specs,
                        StackedFabric(16, "cpu"))
    for got in ranks:
        for key, y in want.items():
            assert torch.equal(got["world1"][key], y), key


def test_backend_device_mismatch_raises(ranks):
    for got in ranks:
        assert len(got["refused"]) == 3, got["refused"]
        assert all("gloo group carries cpu" in m for m in got["refused"])
