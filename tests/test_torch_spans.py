"""The profiler ranges of ``repro_torch.telemetry.spans`` inside the train
step and the fabric.

Without a profiler a span is one shared null context and formats no
label.  Under a CPU profiler one edst step on the 4x4 torus opens each
vertex's ``step/forward/v*``, ``step/backward/v*`` and ``step/rows/v*``
once a microbatch, ``step/sync`` and ``step/optim`` once (ZeRO-1: the
reduce-scatter and the allgather each under ``step/sync``), the engines'
``edst/`` waves as many as before, and the fabric's ``fabric/zero`` once a
``ppermute``, inside the waves.  Over 2 gloo ranks ``fabric/p2p`` opens on
the ``ppermute`` calls whose pairs cross ranks and on no other; a stacked
fabric never opens it.
"""
import json
import os
from contextlib import nullcontext

import pytest
import torch
import torch.distributed as dist

from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import (ProcessGroupFabric, StackedFabric,
                                     record_wires)
from repro_torch.dist.steps import edst_spec_for_mesh, make_train_step
from repro_torch.launch import train as ttrain
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.telemetry.spans import span
from test_torch_fabric_pg import spawn_ranks

MESH, NAMES = (4, 4, 1), ("pod", "data", "model")
N = 16
# on 4 vertices in blocks (0, 1) | (2, 3): local pairs only, and pairs
# that cross the ranks
LOCAL = ((0, 1), (1, 0), (2, 3))
CROSS = ((1, 2), (3, 0), (0, 1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(prof) -> list:
    """``(name, start, end)`` of the trace's ``record_function`` ranges,
    through the Chrome trace the profiler exports."""
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("cat") == "user_annotation"]


def _names(ranges) -> list:
    return [r[0] for r in ranges]


def _inside(inner, outer) -> bool:
    """Whether every range of ``inner`` lies within one of ``outer``."""
    return all(any(a <= s and e <= b for _, a, b in outer)
               for _, s, e in inner)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_without_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = span("step/sync")
    assert isinstance(off, nullcontext)
    assert span("step/forward/v", 3) is off
    assert isinstance(T._scope("edst/t0/w0/reduce"), nullcontext)


def test_span_without_profiler_formats_no_label():
    class Unformattable:
        def __format__(self, spec):
            raise AssertionError("the label was built")

    with span("step/forward/v", Unformattable()):
        pass
    with _profile(), pytest.raises(AssertionError, match="label was built"):
        span("step/forward/v", Unformattable())


def test_span_under_profiler_names_its_range():
    with _profile() as prof:
        with span("step/forward/v", 7):
            torch.ones(3).sum()
        with span("fabric/zero"):
            pass
        with T._scope("edst/t0/w0/reduce"):
            pass
    names = _names(_ranges(prof))
    assert names.count("step/forward/v7") == 1
    assert names.count("fabric/zero") == 1
    assert names.count("edst/t0/w0/reduce") == 1


def _tiny_step(grad_accum, engine, zero1=False):
    """A linear least-squares loss over the 16 vertices of the 4x4 torus,
    so the step's spans are what is counted, not a model."""
    def loss(params, batch):
        r = batch["x"] @ params["w"] - batch["y"]
        return (r * r).mean(), {}

    opt = AdamW(cosine_schedule(1e-2, 2, 10))
    step = make_train_step(None, opt, MESH, NAMES, mode="edst",
                           engine=engine, zero1=zero1,
                           grad_accum=grad_accum, loss=loss)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(8, 5, generator=g)}
    rows = N * grad_accum * 2
    batch = {"x": torch.randn(rows, 8, generator=g),
             "y": torch.randn(rows, 5, generator=g)}
    if zero1:
        from repro_torch.optim.sharded import ShardedAdamW
        state = ShardedAdamW(opt).init_for(
            params, edst_spec_for_mesh(MESH, NAMES, engine=engine), N,
            fabric=StackedFabric(N, "cpu"))
    else:
        state = opt.init(params)
    return step, params, state, batch


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_edst_step_opens_each_span(grad_accum):
    step, params, state, batch = _tiny_step(grad_accum, "fused")
    with record_wires() as calls:
        step(params, state, batch)
    with _profile() as prof:
        step(params, state, batch)
    ranges = _ranges(prof)
    names = _names(ranges)
    for v in range(N):
        for part in ("forward", "backward", "rows"):
            assert names.count(f"step/{part}/v{v}") == grad_accum, (part, v)
    assert len([n for n in names if n.startswith("step/")]) == \
        3 * N * grad_accum + 2
    assert names.count("step/sync") == names.count("step/optim") == 1
    spec = edst_spec_for_mesh(MESH, NAMES, engine="fused")
    waves = [r for r in ranges if r[0].startswith("edst/")]
    assert len(waves) == spec.num_collectives
    # the fabric: a zero fill a ppermute, a local gather where pairs are
    # local (all of them, stacked), no sends; all inside the waves, and
    # the waves inside the sync
    assert names.count("fabric/zero") == len(calls) > 0
    assert names.count("fabric/gather") == len(calls)
    assert "fabric/p2p" not in names
    fab = [r for r in ranges if r[0].startswith("fabric/")]
    assert _inside(fab, waves)
    assert _inside(waves, [r for r in ranges if r[0] == "step/sync"])


def test_zero1_step_syncs_twice_and_updates_once():
    step, params, state, batch = _tiny_step(1, "striped", zero1=True)
    with _profile() as prof:
        step(params, state, batch)
    names = _names(_ranges(prof))
    assert names.count("step/sync") == 2    # reduce-scatter, allgather
    assert names.count("step/optim") == 1
    assert all(names.count(f"step/forward/v{v}") == 1 for v in range(N))


def test_train_cli_trace_carries_the_spans(tmp_path):
    """``--profile-dir``'s Chrome trace: the step's spans inside its
    ``train/step0`` range."""
    res = ttrain.main(["--reduced", "--steps", "1", "--batch", "16",
                       "--seq", "8", "--mesh", "4,4,1", "--sync", "edst",
                       "--device", "cpu",
                       "--profile-dir", str(tmp_path / "prof")])
    with open(res.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"]
    names = _names(ranges)
    assert all(names.count(f"step/{part}/v{v}") == 1 for v in range(N)
               for part in ("forward", "backward", "rows"))
    assert names.count("step/sync") == names.count("step/optim") == 1
    inner = [r for r in ranges if r[0].startswith(("step/", "fabric/"))]
    assert _inside(inner, [r for r in ranges if r[0] == "train/step0"])


def test_stacked_fabric_never_opens_p2p():
    fabric = StackedFabric(4, "cpu")
    x = torch.arange(8.0).reshape(4, 2)
    with _profile() as prof:
        fabric.ppermute(x, CROSS)
        fabric.ppermute(x, LOCAL)
        fabric.ppermute(x, ())
    names = _names(_ranges(prof))
    assert names.count("fabric/zero") == 3
    assert names.count("fabric/gather") == 2
    assert "fabric/p2p" not in names


def _rank_main(rank, world, init, out_dir):
    """One gloo rank of a 4-vertex fabric (2 vertices a rank): the ranges
    of a ppermute with local pairs only, one with pairs across the ranks,
    and the 2x2 torus's allreduce."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fabric = ProcessGroupFabric(4, "cpu")
        x = torch.arange(8.0).reshape(4, 2)[fabric.lo:fabric.hi]
        out = {}
        for key, perm in (("local", LOCAL), ("cross", CROSS)):
            with _profile() as prof:
                out[key + "_rows"] = fabric.ppermute(x, perm)
            out[key] = _ranges(prof)
        spec = edst_spec_for_mesh((2, 2, 1), NAMES)
        with _profile() as prof:
            T.tree_allreduce(torch.ones(fabric.rows, 6), spec, fabric)
        out["allreduce"] = _ranges(prof)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("spans_pg"), _rank_main,
                       world=2)


def test_process_group_fabric_opens_p2p_only_across_ranks(ranks):
    x = torch.arange(8.0).reshape(4, 2)
    want = {"local": StackedFabric(4, "cpu").ppermute(x, LOCAL),
            "cross": StackedFabric(4, "cpu").ppermute(x, CROSS)}
    for r, out in enumerate(ranks):
        lo = 2 * r
        for key in ("local", "cross"):
            assert torch.equal(out[key + "_rows"], want[key][lo:lo + 2])
        local, cross = _names(out["local"]), _names(out["cross"])
        assert local.count("fabric/zero") == 1
        assert "fabric/p2p" not in local
        assert cross.count("fabric/zero") == cross.count("fabric/p2p") == 1
        waves = [w for w in out["allreduce"] if w[0].startswith("edst/")]
        p2p = [w for w in out["allreduce"] if w[0] == "fabric/p2p"]
        assert waves and p2p and _inside(p2p, waves)
