"""The wave-by-wave timer on the card (marked ``gpu``; they skip without a
CUDA device): the runner's final rows equal the pipelined and striped
engines' results on the card and on the CPU bit for bit, its reduce hops
launch the tree-combine kernel, every measured wave is finite and
positive, a measured trace validates, and ``segments="auto"`` on the card
reads the ``cuda`` row.  This file imports neither JAX nor the reference,
so it runs on a machine that has only PyTorch:

    python -m pytest -q tests/test_torch_timing_gpu.py
"""
import json
import math

import pytest
import torch

from repro_torch.core import topologies as topo
from repro_torch.core.collectives import (CostModel, allreduce_schedule,
                                          pipelined_spec_from_schedule,
                                          striped_spec_from_schedule,
                                          wave_wire_bytes)
from repro_torch.core.edst_star import star_edsts
from repro_torch.dist import striped as S
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import StackedFabric
from repro_torch.kernels.tree_combine import kernel as K
from repro_torch.telemetry import timing as tim
from repro_torch.telemetry import trace as ttr

TORI = {"torus4x4": (4, 4), "torus2x8": (2, 8)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _spec(engine, dims):
    sp = topo.device_topology(dims)
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    if engine == "striped":
        return striped_spec_from_schedule(sched, ("data",))
    return pipelined_spec_from_schedule(sched, ("data",))


def _engine(engine, x, spec, fabric):
    if engine == "pipelined":
        return T.pipelined_tree_allreduce(x, spec, fabric, segments=1)
    return S.striped_allreduce(x, spec, fabric)


def _waves(spec, x):
    prep, fns, finish = tim.wave_steps(spec, StackedFabric(16, x.device),
                                       x.shape[1])
    state = prep(x)
    for fn in fns:
        state = fn(state)
    return finish(state)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ("pipelined", "striped"))
@pytest.mark.parametrize("torus", TORI)
def test_runner_equals_the_engines_on_the_card(torus, engine):
    dev = _cuda()
    spec = _spec(engine, TORI[torus])
    g = torch.Generator(device=dev).manual_seed(0)
    for size in (1, 4099, (1 << 20) + 5):
        x = torch.randn((16, size), generator=g, device=dev)
        K.reset_launches()
        out = _waves(spec, x)
        torch.cuda.synchronize()
        assert K.LAUNCHES["tree_combine"] > 0
        assert torch.equal(out, _engine(engine, x, spec,
                                        StackedFabric(16, dev)))
        assert torch.equal(out.cpu(), _waves(spec, x.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ("pipelined", "striped"))
def test_measured_waves_on_the_card(engine, tmp_path):
    _cuda()
    spec = _spec(engine, TORI["torus4x4"])
    rep = tim.wave_report(spec, 1 << 20, iters=2)
    assert rep["device"] == "cuda"
    assert rep["wire_bytes"] == list(wave_wire_bytes(spec, 1 << 20))
    for key in ("measured_us", "host_us"):
        assert len(rep[key]) == rep["waves"]
        assert all(t > 0 and math.isfinite(t) for t in rep[key])
    cm = CostModel.for_backend("cuda")
    assert rep["predicted_us"] == [round(t * 1e6, 3) for t in
                                   cm.wave_times(spec, 1 << 20)]
    out = tmp_path / "m.json"
    assert ttr.main(["--engine", engine, "--measured", "--nbytes",
                     str(1 << 20), "--out", str(out), "--validate"]) == 0
    assert ttr.validate_trace(json.loads(out.read_text())) == []


@pytest.mark.gpu
def test_auto_segments_on_the_card_reads_the_cuda_row():
    dev = _cuda()
    spec = _spec("pipelined", TORI["torus4x4"])
    assert CostModel.calibration_for("cuda")["overlap"] is False
    for elems in (1 << 19, 134_515_008 // 2):
        assert T.auto_segments(spec, elems, dev) == \
            CostModel.for_backend("cuda").best_segments(
                4 * elems * spec.k, spec) == 1
    assert T.resolve_codec("auto", dev) == "full"
