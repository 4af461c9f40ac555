"""``repro_torch.analysis.hlo`` (the per-device program analyser and the
contract linter), ``analysis.roofline`` and ``verify.hlo_contract_for``
against the reference's.

  * the reference's ``tests/test_analysis.py`` fixtures in torch form:
    10 and 3 x 5 looped 128^3 matmuls count exactly 2 * 128^3 * 10 and
    * 15 (eager loops run in full); a body constant does not change the
    count; an in-place row update in a loop counts the row, not the
    buffer; a program with no collective counts none;
  * the three local counts on a 16-wide axis (a ``fake`` group of 16
    ranks, in a subprocess: the group is process-wide): a matmul split by
    rows counts 1/16 of the global FLOPs, a replicated one the whole, one
    split on the contraction dim 1/16 plus its reduction's all-reduce
    (the output's bytes);
  * ``model_flops_for`` equal to the reference's for all ten configs x
    four shapes, and the roofline's terms from the H100's constants;
  * ``hlo_contract_for`` field for field equal to the reference's for
    every engine on the five paper topologies, f32 and int8, with and
    without ``m``, and the striped engine's four phases;
  * each engine's recorded run, on the stacked fabric and over 4 gloo
    ranks, passing ``lint_hlo`` against its contract at S = 1 and S = 4,
    and a contract one ``ppermute`` short flagged.
"""
import json
import os
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.analysis import roofline as jroof
from repro.analysis import verify as jverify
from repro_torch import configs as tconfigs
from repro_torch.analysis import roofline as troof
from repro_torch.analysis import verify as tverify
from repro_torch.analysis.hlo import (HloContract, analyze_program,
                                      collective_sites, lint_hlo)
from repro_torch.core.collectives import CostModel
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import (ProcessGroupFabric, StackedFabric,
                                     record_wires)
from test_torch_fabric_pg import LENGTH, _payload, _run, _specs, spawn_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PAPER = tverify.PAPER_TOPOLOGIES


# ---------------------------------------------------------------------------
# the analyser on eager loops
# ---------------------------------------------------------------------------

def test_loop_flops_exact():
    x = torch.randn(128, 128)

    def f(x):
        c = x
        for _ in range(10):
            c = c @ x
        return c.sum()
    assert analyze_program(f, x).dot_flops == 2 * 128 ** 3 * 10


def test_nested_loop_flops_exact():
    x = torch.randn(128, 128)

    def f(x):
        c = x
        for _ in range(5):
            for _ in range(3):
                c = c @ x
        return c
    assert analyze_program(f, x).dot_flops == 2 * 128 ** 3 * 15


def test_body_constant_does_not_count():
    x = torch.randn(64, 64)

    def f(x):
        c = x
        for _ in range(10):
            c = c @ x + 32768.0
        return c
    assert analyze_program(f, x).dot_flops == 2 * 64 ** 3 * 10


def test_in_place_update_loop_not_overcounted():
    buf = torch.zeros(100000, 64)
    upd = torch.ones(1, 64)

    def f(buf, upd):
        for i in range(50):
            buf[i:i + 1] = upd
        return buf
    st = analyze_program(f, buf, upd)
    overcount = 100000 * 64 * 4 * 50          # full buffer x iterations
    assert 0 < st.bytes_touched < 0.2 * overcount


def test_no_collectives_counted_without_any():
    st = analyze_program(lambda x: x * 2, torch.zeros(8))
    assert st.total_collective_bytes == 0
    assert set(st.collective_counts) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_mm_family_counted():
    a, b = torch.randn(4, 8, 16), torch.randn(4, 16, 32)
    c = torch.randn(8, 32)
    st = analyze_program(lambda: (torch.bmm(a, b), torch.addmm(c, a[0], b[0]),
                                  torch.baddbmm(a @ b, a, b)))
    # bmm, addmm, the matmul's bmm and baddbmm
    assert st.dot_flops == 2 * 8 * 32 * 16 * (4 + 1 + 4 + 4)


def test_meta_tensors_hold_no_memory():
    """A tensor on the meta device (a shape, a stride) is no device's
    memory: the recorder's live and peak bytes leave it out."""
    from repro_torch.analysis.hlo import ProgramRecorder
    x = torch.zeros(1000)
    with ProgramRecorder() as rec:
        y = x * 2
        torch.empty((1 << 20, 1 << 20), device="meta").stride()
    assert rec.peak_bytes == y.untyped_storage().nbytes() == 4000


LOCAL_CODE = r"""
import json, torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
from repro_torch.analysis.hlo import analyze_program
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((16,), ("model",))
M = K = N = 256
a, b = torch.randn(M, K), torch.randn(K, N)
out = {}
for name, pa, pb in (("rows", Shard(0), Replicate()),
                     ("replicated", Replicate(), Replicate()),
                     ("contraction", Shard(1), Shard(0))):
    da = distribute_tensor(a, mesh, [pa], src_data_rank=None)
    db = distribute_tensor(b, mesh, [pb], src_data_rank=None)
    st = analyze_program(
        lambda: (da @ db).redistribute(mesh, [Replicate()]))
    out[name] = {"flops": st.dot_flops, "bytes": st.collective_bytes,
                 "counts": st.collective_counts}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def local_counts():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", LOCAL_CODE],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["rows", "replicated", "contraction"])
def test_local_counts_on_a_16_wide_axis(local_counts, case):
    full = 2.0 * 256 ** 3
    got = local_counts[case]
    want = {"rows": full / 16, "replicated": full,
            "contraction": full / 16}[case]
    assert got["flops"] == want
    reduced = {k: v for k, v in got["counts"].items() if v}
    if case == "contraction":
        # the partial sums' all-reduce: the (M, N) f32 output
        assert reduced == {"all-reduce": 1}
        assert got["bytes"]["all-reduce"] == 256 * 256 * 4
    elif case == "rows":
        # the row-split output gathered
        assert reduced == {"all-gather": 1}
        assert got["bytes"]["all-gather"] == 256 * 256 * 4
    else:
        assert reduced == {}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_model_flops_equal_the_reference(arch):
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    for shape in jconfigs.LM_SHAPES:
        for n in (1, 256, 512):
            assert troof.model_flops_for(tc, tc.shape(shape.name), n) == \
                jroof.model_flops_for(jc, shape, n), (shape.name, n)


def test_roofline_terms_on_the_h100():
    cfg = tconfigs.get("qwen3-8b")
    shape = cfg.shape("train_4k")
    t = troof.roofline(cfg, shape, "16x16", 256, 1e15, 1e12, 1e10)
    assert t.compute_s == 1e15 / 989e12
    assert t.memory_s == 1e12 / 3.35e12
    assert troof.link_bw() == CostModel.for_backend("cuda").link_bw
    assert t.collective_s == 1e10 / CostModel.for_backend("cuda").link_bw
    assert t.dominant == "compute"
    assert 0 < t.roofline_fraction <= 1.5
    row = t.row()
    assert set(row) == set(jroof.roofline(
        jconfigs.get("qwen3-8b"), jconfigs.get("qwen3-8b").shape("train_4k"),
        "16x16", 256, 1e15, 1e12, 1e10).row())


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def _spec_pairs(label):
    sched_t = tverify._schedule_for(label)
    sched_j = jverify._schedule_for(label)
    engines = tverify.ENGINES
    return (tverify._compile_specs(sched_t, engines),
            jverify._compile_specs(sched_j, engines))


@pytest.mark.parametrize("label", PAPER)
def test_contract_equals_the_reference(label):
    tspecs, jspecs = _spec_pairs(label)
    n = 0
    for eng in tverify.ENGINES:
        ts, js = tspecs[eng], jspecs[eng]
        phases = ("composed", "rs", "ag", "zero1") if eng == "striped" \
            else ("composed",)
        for phase in phases:
            for quantize in (False, True):
                for m in (None, LENGTH, 4096):
                    got = tverify.hlo_contract_for(ts, quantize, m, phase)
                    want = jverify.hlo_contract_for(js, quantize, m, phase)
                    assert isinstance(got, HloContract)
                    assert asdict(got) == asdict(want), (eng, phase,
                                                         quantize, m)
                    n += 1
    assert n == 3 * 2 * 3 + 4 * 2 * 3
    with pytest.raises(ValueError, match="needs the striped engine"):
        tverify.hlo_contract_for(tspecs["fused"], phase="rs")


# the engines of test_torch_fabric_pg's runner: (spec, phase) of each
ENGINE_SPEC = {"per_tree": ("per_tree", "composed"),
               "fused": ("fused", "composed"),
               "pipe_s1": ("pipelined", "composed"),
               "pipe_s4": ("pipelined", "composed"),
               "striped": ("striped", "composed"),
               "rs": ("striped", "rs"),
               "ag": ("striped", "zero1")}   # the runner reduce-scatters first


def _run_engine(eng, x, specs, fabric, quantize):
    """``test_torch_fabric_pg._run``, but the per-tree int8 path's trees
    run under their own wave names, as ``per_tree_allreduce`` runs them
    (that runner calls ``run_tree_program`` with the default name)."""
    if eng != "per_tree" or not quantize:
        return _run(eng, x, specs, fabric, quantize)
    spec = specs["per_tree"]
    chunks = torch.nn.functional.pad(x, (0, -x.shape[1] % spec.k)).view(
        x.shape[0], spec.k, -1)
    return [T.run_tree_program(chunks[:, j].contiguous(), tree, fabric,
                               True, codec="full", scope_tree=j)
            for j, tree in enumerate(spec.trees)]


def _recorded_runs(specs, x, fabric):
    """``{(engine, int8): (calls, sites, lint findings)}`` of every
    engine."""
    out = {}
    for eng, (which, phase) in ENGINE_SPEC.items():
        for q in (False, True):
            with record_wires() as calls:
                _run_engine(eng, x, specs, fabric, q)
            contract = tverify.hlo_contract_for(specs[which], q, m=LENGTH,
                                                phase=phase)
            out[eng, q] = (len(calls), len(collective_sites(calls)),
                           lint_hlo(calls, contract))
    return out


@pytest.mark.parametrize("label", PAPER)
def test_recorded_runs_pass_the_contract_stacked(label):
    specs = _specs(label)
    n = specs["pipelined"].n
    runs = _recorded_runs(specs, torch.from_numpy(_payload(n, 0)),
                          StackedFabric(n, "cpu"))
    for key, (calls, sites, bad) in runs.items():
        assert bad == [], (key, bad)
    # S = 4 streams four segments through each wave's one site
    assert runs["pipe_s4", False][0] > runs["pipe_s1", False][0]
    assert runs["pipe_s4", False][1] == runs["pipe_s1", False][1]


def _rank_main(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = {}
        for i, label in enumerate(PAPER):
            specs = _specs(label)
            n = specs["pipelined"].n
            fabric = ProcessGroupFabric(n, "cpu")
            x = torch.from_numpy(_payload(n, i))[fabric.lo:fabric.hi]
            out[label] = _recorded_runs(specs, x, fabric)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("analysis_pg"), _rank_main)


@pytest.mark.parametrize("label", PAPER)
def test_recorded_runs_pass_the_contract_over_ranks(ranks, label):
    stacked = _recorded_runs(
        _specs(label), torch.from_numpy(_payload(_specs(label)["pipelined"].n,
                                                 0)),
        StackedFabric(_specs(label)["pipelined"].n, "cpu"))
    for r in ranks:
        for key, (calls, sites, bad) in r[label].items():
            assert bad == [], (key, bad)
            # every rank issues each wave's call, as the stacked run does
            assert (calls, sites) == stacked[key][:2], key


def test_a_missing_ppermute_is_flagged():
    specs = _specs("torus4x4")
    x = torch.from_numpy(_payload(16, 3))
    with record_wires() as calls:
        _run("pipe_s1", x, specs, StackedFabric(16, "cpu"), False)
    contract = tverify.hlo_contract_for(specs["pipelined"])
    assert lint_hlo(calls, contract) == []
    short = HloContract(ppermutes=contract.ppermutes - 1)
    bad = lint_hlo(calls, short)
    assert len(bad) == 1 and "site count" in bad[0]
    # an unquantized wire where the contract caps the f32 sites
    capped = HloContract(max_f32_sites=0)
    assert any("f32-wire" in b for b in lint_hlo(calls, capped))
    assert np.all([c.dtype == torch.float32 for c in calls])
