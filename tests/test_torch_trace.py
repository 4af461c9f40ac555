"""The port's Perfetto trace exporter against the reference's: the
normalized messages, the happens-before DAG and the whole trace of every
engine on the five paper topologies; the reference's golden torus trace;
a fault runtime's entry table; the schema validator on the reference's
two broken traces; the trace CLI and the verifier's ``--trace``; and the
trace ``launch.train --trace-out`` writes on the CPU.  Traces are equal
event for event; only ``otherData.generator`` names the package."""
import contextlib
import io
import json
import os
from functools import lru_cache

import pytest
import torch

from repro.analysis import verify as jver
from repro.dist import steps as jsteps
from repro.telemetry import trace as jtr
from repro_torch.analysis import verify as tver
from repro_torch.core.collectives import CostModel
from repro_torch.dist import steps as tsteps
from repro_torch.launch import train
from repro_torch.optim.adamw import tree_leaves
from repro_torch.telemetry import trace as ttr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ENGINES = ("per_tree", "fused", "pipelined", "striped")
MESH = ((4, 4, 1), ("pod", "data", "model"))


@lru_cache(maxsize=None)
def specs_for(pkg: str, label: str):
    ver = jver if pkg == "jax" else tver
    return ver._compile_specs(ver._schedule_for(label), ENGINES)


def pair(label, engine):
    return specs_for("jax", label)[engine], specs_for("port", label)[engine]


def same_trace(mine, ref):
    """Equal event for event, the generator names aside."""
    assert mine["otherData"].pop("generator") == \
        "repro_torch.telemetry.trace"
    assert ref["otherData"].pop("generator") == "repro.telemetry.trace"
    assert mine == ref


@pytest.mark.parametrize("label", tver.PAPER_TOPOLOGIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_spec_messages_equal_reference(label, engine):
    ref, mine = pair(label, engine)
    for nbytes in (ttr.DEFAULT_NBYTES, 1001):
        got = ttr.spec_messages(mine, nbytes)
        assert got == jtr.spec_messages(ref, nbytes)
        assert got[1], "no messages"
    if mine.k == 2 and engine != "per_tree":
        assert ttr.spec_messages(mine, 4096, fractions=(0.7, 0.3)) == \
            jtr.spec_messages(ref, 4096, fractions=(0.7, 0.3))


@pytest.mark.parametrize("label", tver.PAPER_TOPOLOGIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_happens_before_equal_reference(label, engine):
    ref, mine = pair(label, engine)
    msgs = ttr.spec_messages(mine)[1]
    edges = ttr.happens_before(msgs)
    assert edges == jtr.happens_before(jtr.spec_messages(ref)[1])
    assert all(msgs[p][0] < msgs[c][0] for p, c in edges)


@pytest.mark.parametrize("label", tver.PAPER_TOPOLOGIES)
@pytest.mark.parametrize("engine", ENGINES)
def test_trace_spec_equal_reference(label, engine):
    ref, mine = pair(label, engine)
    for lane in ("device", "tree"):
        got = ttr.trace_spec(mine, lane=lane, label=f"{label}/{engine}")
        assert ttr.validate_trace(got) == []
        same_trace(got, jtr.trace_spec(ref, lane=lane,
                                       label=f"{label}/{engine}"))
    # measured wave times and another CostModel pass through alike
    n = len(ttr.spec_messages(mine)[0])
    times = [1e-4 * (w + 1) for w in range(n)]
    same_trace(ttr.trace_spec(mine, wave_times=times, pid=3, flow_base=7),
               jtr.trace_spec(ref, wave_times=times, pid=3, flow_base=7))
    cm = CostModel(link_bw=1.3e10, alpha=2e-5, overlap=False)
    from repro.core.collectives import CostModel as JCostModel
    jcm = JCostModel(link_bw=1.3e10, alpha=2e-5, overlap=False)
    same_trace(ttr.trace_spec(mine, nbytes=1 << 26, cost_model=cm),
               jtr.trace_spec(ref, nbytes=1 << 26, cost_model=jcm))


def test_golden_torus4x4_pipelined():
    """The reference's committed golden trace, generator aside."""
    spec = specs_for("port", "torus4x4")["pipelined"]
    tr = ttr.trace_spec(spec, label="torus4x4/pipelined")
    with open(os.path.join(GOLDEN, "trace_torus4x4_pipelined.json")) as f:
        golden = json.load(f)
    same_trace(tr, golden)


@pytest.mark.parametrize("engine", ("pipelined", "striped"))
def test_trace_runtime_equal_reference(engine):
    """The 16-vertex torus's fault runtime: one lane group per entry,
    each with its own stripe fractions."""
    mine = tsteps.fault_runtime_for_mesh((16, 1), ("data", "model"),
                                         dp_torus_shape=(4, 4),
                                         engine=engine)
    ref = jsteps.fault_runtime_for_mesh((16, 1), ("data", "model"),
                                        dp_torus_shape=(4, 4),
                                        engine=engine)
    for nbytes in (1 << 12, ttr.DEFAULT_NBYTES):
        tr = ttr.trace_runtime(mine, nbytes=nbytes)
        assert ttr.validate_trace(tr) == []
        assert len({e["pid"] for e in tr["traceEvents"]
                    if e["ph"] == "X"}) >= 2
        same_trace(tr, jtr.trace_runtime(ref, nbytes=nbytes))


def _broken_traces(tr):
    """The reference's two breakages: a negative timestamp, and every
    flow finish orphaned."""
    neg = json.loads(json.dumps(tr))
    neg["traceEvents"][-1]["ts"] = -1.0
    orphan = json.loads(json.dumps(tr))
    for e in orphan["traceEvents"]:
        if e["ph"] == "f":
            e["id"] += 10_000
    return neg, orphan


def test_validator_catches_the_reference_breakages():
    spec = specs_for("port", "torus4x4")["fused"]
    tr = ttr.trace_spec(spec)
    assert ttr.validate_trace(tr) == []
    for bad in _broken_traces(tr):
        got = ttr.validate_trace(bad)
        assert got and got == jtr.validate_trace(bad)
    for bad in ({}, {"traceEvents": []}, {"traceEvents": [{"ph": "X"}]},
                {"traceEvents": [{"name": "a", "ph": "Q", "ts": 0,
                                  "pid": 0, "tid": 0}]}):
        assert ttr.validate_trace(bad) == jtr.validate_trace(bad) != []


def _files(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".json"))


def _same_dirs(mine_dir, ref_dir, count):
    names = _files(mine_dir)
    assert names == _files(ref_dir) and len(names) == count
    for name in names:
        with open(os.path.join(mine_dir, name)) as f:
            mine = json.load(f)
        with open(os.path.join(ref_dir, name)) as f:
            ref = json.load(f)
        assert ttr.validate_trace(mine) == []
        same_trace(mine, ref)


def test_trace_cli_writes_the_reference_files(tmp_path):
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    argv = ["--topologies", "paper5", "--all-engines", "--validate"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert ttr.main(argv + ["--out-dir", str(mine)]) == 0
        assert jtr.main(argv + ["--out-dir", str(ref)]) == 0
    assert out.getvalue().count("schema OK") == 40
    _same_dirs(mine, ref, 20)
    one, jone = tmp_path / "one.json", tmp_path / "jone.json"
    for m, o in ((ttr, one), (jtr, jone)):
        with contextlib.redirect_stdout(io.StringIO()):
            assert m.main(["--topology", "slimfly", "--engine", "striped",
                           "--lane", "tree", "--nbytes", "65536",
                           "--out", str(o)]) == 0
    same_trace(json.loads(one.read_text()), json.loads(jone.read_text()))


def test_trace_cli_refuses_an_ambiguous_topology():
    with pytest.raises(SystemExit):
        ttr.main(["--topology", "x"])


def test_verify_trace_writes_the_reference_files(tmp_path):
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    argv = ["--topologies", "torus4x4,slimfly_q5", "--level", "cheap"]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tver.main(argv + ["--trace", str(mine)]) == 0
        assert jver.main(argv + ["--trace", str(ref)]) == 0
    assert out.getvalue().count("  trace -> ") == 16
    _same_dirs(mine, ref, 8)
    with open(mine / "trace_torus4x4_pipelined.json") as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert {e["args"]["wire_bytes"] for e in spans} == \
        {tver._STATS_NBYTES // 2}


TRAIN = ["--reduced", "--steps", "1", "--batch", "16", "--seq", "16",
         "--mesh", "4,4,1", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--sync", "edst"], ["--sync", "edst", "--edst-engine", "striped"],
    ["--sync", "edst", "--edst-engine", "fused"], ["--zero1"],
    ["--sync", "edst", "--recover"]],
    ids=["pipelined", "striped", "fused", "zero1", "recover"])
def test_train_trace_out_is_the_reference_trace(tmp_path, extra):
    """A CPU ``launch.train --trace-out`` run writes the reference's trace
    of the same program at 4 bytes a parameter (the default CostModel:
    the reference's constants)."""
    out = tmp_path / "sync.json"
    with contextlib.redirect_stdout(io.StringIO()) as log:
        res = train.main(TRAIN + extra + ["--trace-out", str(out)])
    assert "predicted sync trace -> " in log.getvalue()
    assert "by the default CostModel" in log.getvalue()
    nbytes = 4 * sum(p.numel() for p in tree_leaves(res.params))
    dims, names = MESH
    if "--recover" in extra:
        ref = jtr.trace_runtime(jsteps.fault_runtime_for_mesh(dims, names),
                                nbytes=nbytes)
    else:
        engine = "striped" if "--zero1" in extra else (
            extra[-1] if "--edst-engine" in extra else "pipelined")
        ref = jtr.trace_spec(jsteps.edst_spec_for_mesh(dims, names,
                                                       engine=engine),
                             nbytes=nbytes, label=f"edst/{engine}")
    mine = json.loads(out.read_text())
    assert ttr.validate_trace(mine) == []
    same_trace(mine, ref)


@pytest.mark.parametrize("argv", [["--mesh", "1,1", "--sync", "edst"],
                                  ["--sync", "psum_dp"]],
                         ids=["one-vertex", "psum_dp"])
def test_train_trace_out_skips_without_an_edst_program(tmp_path, argv):
    out = tmp_path / "sync.json"
    with contextlib.redirect_stdout(io.StringIO()) as log:
        train.main(TRAIN + argv + ["--steps", "0", "--trace-out", str(out)])
    assert "--trace-out skipped: no compiled EDST sync program" in \
        log.getvalue()
    assert not out.exists()


def test_train_trace_out_on_cuda_uses_the_cuda_row(tmp_path, monkeypatch):
    """Where the device is CUDA the spans are timed by the ``cuda`` row:
    the same trace as the reference's exporter under those constants
    (the run itself stops before training: no card here)."""
    from repro.core.collectives import CostModel as JCostModel
    args = train.parser().parse_args(TRAIN + ["--sync", "edst",
                                              "--trace-out",
                                              str(tmp_path / "s.json")])
    run, params, _ = train.setup(args)
    run.device = torch.device("cuda", 0)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        train.write_sync_trace(args, run, params)
    cm = CostModel.for_backend("cuda")
    assert f"by the cuda CostModel: alpha {cm.alpha!r} s" in log.getvalue()
    nbytes = 4 * sum(p.numel() for p in tree_leaves(params))
    ref = jtr.trace_spec(jsteps.edst_spec_for_mesh(*MESH), nbytes=nbytes,
                         label="edst/pipelined",
                         cost_model=JCostModel(link_bw=cm.link_bw,
                                               alpha=cm.alpha,
                                               overlap=False))
    same_trace(json.loads((tmp_path / "s.json").read_text()), ref)
