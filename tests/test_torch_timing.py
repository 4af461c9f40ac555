"""The port's wave-by-wave timer against the reference's
``repro.telemetry.timing``: the calibration fit on the same arrays, the
static half of ``wave_report`` (wire bytes and predicted times under one
CostModel), and on the CPU the runner itself: wave by wave, its final rows
are the pipelined and striped engines' results bit for bit.  Then the
``cuda`` row of the CostModel that ``segments="auto"`` reads on the card,
``register_measured`` and the timer's refusal to leave the card."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import collectives as jcol
from repro.telemetry import timing as jtim
from repro_torch.core import collectives as tcol
from repro_torch.core import topologies as topo
from repro_torch.core.collectives import CostModel
from repro_torch.core.edst_star import star_edsts
from repro_torch.dist import striped as S
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import StackedFabric
from repro_torch.telemetry import timing as tim
from repro_torch.telemetry import trace as ttr

TORI = {"torus4x4": (4, 4), "torus2x8": (2, 8)}     # k = 2 and k = 1
FULL = 134_515_008             # smollm-135m: the training path's payload
WEIGHTS = {"uniform": None, "weighted": (0.7, 0.3), "one-tree": (1.0, 0.0)}


def fractions_for(name, k):
    """The named stripe weights for k trees (k = 1 takes all of them)."""
    w = WEIGHTS[name]
    return w if w is None or k == 2 else (1.0,)


def specs(dims):
    """``{engine: (reference spec, port spec)}`` for a torus."""
    from repro.core import edst_star as jstar
    from repro.core import topologies as jtopo
    js = jcol.allreduce_schedule(16, jstar.star_edsts(
        jtopo.device_topology(dims)).trees)
    ts = tcol.allreduce_schedule(16, star_edsts(
        topo.device_topology(dims)).trees)
    return {e: (getattr(jcol, f"{e}_spec_from_schedule")(js, ("data",)),
                getattr(tcol, f"{e}_spec_from_schedule")(ts, ("data",)))
            for e in ("pipelined", "striped")}


FIT_CASES = {
    "line": ([1e3, 2e3, 4e3, 8e3], [1.1e-4, 1.2e-4, 1.4e-4, 1.8e-4]),
    "noisy": ([4096, 65536, 65536, 1 << 20, 3 << 20],
              [5e-5, 9e-5, 8.7e-5, 4.1e-4, 1.2e-3]),
    "one width": ([4096] * 3, [1e-4, 2e-4, 3e-4]),
    "one sample": ([4096], [1e-4]),
    "empty": ([], []),
    "negative slope": ([1e3, 2e3, 3e3], [3e-4, 2e-4, 1e-4]),
    "negative intercept": ([1e6, 2e6, 3e6], [1e-4, 3e-4, 5e-4]),
}


@pytest.mark.parametrize("case", FIT_CASES)
def test_fit_calibration_equals_reference(case):
    wires, secs = FIT_CASES[case]
    got = tim.fit_calibration(wires, secs)
    assert got == jtim.fit_calibration(wires, secs)
    assert got["alpha"] >= 0 and got["link_bw"] > 0


@pytest.mark.parametrize("weights", ("uniform", "weighted"))
@pytest.mark.parametrize("engine", ("pipelined", "striped"))
@pytest.mark.parametrize("torus", TORI)
def test_wave_report_static_half_equals_reference(torus, engine, weights,
                                                  monkeypatch):
    """Wire bytes and predicted times of ``wave_report`` under one
    CostModel, the reference's computed by its own ``wave_report`` (its
    measurement stubbed: this process has one JAX device)."""
    ref, mine = specs(TORI[torus])[engine]
    fractions = fractions_for(weights, mine.k)
    nbytes = 1 << 16
    monkeypatch.setattr(jtim, "measured_wave_times",
                        lambda spec, nb, it, fr, mesh: (0.0,) * len(
                            jcol.wave_wire_bytes(spec, nb, 4, fr)))
    for consts in ({}, {"link_bw": 1.3e10, "alpha": 2.5e-5,
                        "overlap": False}):
        got = tim.wave_report(mine, nbytes, iters=1, fractions=fractions,
                              cost_model=CostModel(**consts), device="cpu")
        want = jtim.wave_report(ref, nbytes, iters=1, fractions=fractions,
                                cost_model=jcol.CostModel(**consts))
        for key in ("engine", "waves", "nbytes", "wire_bytes",
                    "predicted_us"):
            assert got[key] == want[key], key
        assert got["summary"]["predicted_total_us"] == \
            want["summary"]["predicted_total_us"]
        assert got["device"] == "cpu"
        assert len(got["measured_us"]) == len(got["host_us"]) == \
            got["waves"]
        assert all(m > 0 and math.isfinite(m) for m in got["measured_us"])
        # on the CPU the device time is the host clock
        assert got["measured_us"] == got["host_us"]
        assert got["residual_us"] == pytest.approx(
            [m - p for m, p in zip(got["measured_us"],
                                   got["predicted_us"])], abs=2e-3)


def test_wave_report_predicts_from_the_devices_row():
    _, mine = specs(TORI["torus4x4"])["pipelined"]
    rep = tim.wave_report(mine, 4096, iters=1, device="cpu")
    cpu = CostModel.for_backend("cpu").wave_times(mine, 4096)
    assert rep["predicted_us"] == [round(t * 1e6, 3) for t in cpu]


def _engine(engine, x, spec, fabric, fractions):
    if engine == "pipelined":
        return T.pipelined_tree_allreduce(x, spec, fabric, segments=1,
                                          fractions=fractions)
    return S.striped_allreduce(x, spec, fabric, fractions=fractions)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("engine", ("pipelined", "striped"))
@pytest.mark.parametrize("torus", TORI)
def test_runner_rows_equal_the_engines(torus, engine, weights):
    """Run wave by wave, the timer's program ends on the engine's own
    result, bit for bit (ragged lengths), and that is the sum."""
    _, spec = specs(TORI[torus])[engine]
    fractions = fractions_for(weights, spec.k)
    fabric = StackedFabric(16, "cpu")
    for size in (1, 1001, 4099):
        x = torch.from_numpy(np.random.RandomState(size).randn(16, size)
                             .astype(np.float32))
        prep, fns, finish = tim.wave_steps(spec, fabric, size, fractions)
        assert len(fns) == len(tcol.wave_wire_bytes(spec, 4 * size, 4,
                                                    fractions))
        state = prep(x)
        for fn in fns:
            state = fn(state)
        out = finish(state)
        assert torch.equal(out, _engine(engine, x, spec, fabric, fractions))
        assert float((out - x.sum(0)).abs().max()) < 1e-5


def test_runner_refuses_the_baselines():
    from repro_torch.analysis.verify import _compile_specs, _schedule_for
    sp = _compile_specs(_schedule_for("torus4x4"), ("fused", "per_tree"))
    for spec in sp.values():
        with pytest.raises(NotImplementedError):
            tim.wave_steps(spec, StackedFabric(16, "cpu"), 8)


def test_timer_never_leaves_the_card(monkeypatch, tmp_path):
    """A CUDA request without a CUDA device raises (and the trace CLI
    exits non-zero); only ``device="cpu"`` times on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, spec = specs(TORI["torus4x4"])["striped"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tim.measured_wave_times(spec, 4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tim.wave_report(spec, 4096, device="cuda")
    out = tmp_path / "m.json"
    with pytest.raises(SystemExit) as e:
        ttr.main(["--engine", "striped", "--measured", "--out", str(out)])
    assert e.value.code not in (None, 0) and not out.exists()
    assert ttr.main(["--engine", "striped", "--measured", "--device", "cpu",
                     "--nbytes", "4096", "--out", str(out),
                     "--validate"]) == 0
    import json
    spans = [e for e in json.loads(out.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert {e["args"]["wave"] for e in spans} == \
        set(range(len(tcol.wave_wire_bytes(spec, 4096))))


def test_cuda_row_is_read_by_auto_segments(monkeypatch):
    """``segments="auto"`` on CUDA asks ``CostModel.for_backend("cuda")``:
    the built-in row (waves never overlap on the stacked fabric) picks 1
    at every row width, and a registered calibration changes the pick."""
    monkeypatch.setattr(CostModel, "_MEASURED", {})
    row = CostModel.calibration_for("cuda")
    assert row is CostModel._BUILTIN["cuda"] and row["overlap"] is False
    assert row["alpha"] > 0 and math.isfinite(row["link_bw"]) \
        and row["link_bw"] > 0
    _, pspec = specs(TORI["torus4x4"])["pipelined"]
    cuda = torch.device("cuda", 0)
    for elems in (1, 1 << 19, FULL // 2):
        assert T.auto_segments(pspec, elems, cuda) == 1
        assert T.resolve_segments("auto", pspec, elems, "cuda") == 1
    assert CostModel.for_backend("cuda").best_segments(4 * FULL, pspec) == 1
    # the pick follows the row: an overlapping fabric streams
    CostModel.register_calibration("cuda", link_bw=1e10, alpha=1e-6,
                                   overlap=True)
    assert T.auto_segments(pspec, FULL // 2, cuda) > 1
    assert T.auto_segments(pspec, FULL // 2, "cpu") == 1
    # codec="auto" stays the reference's backend split
    assert T.resolve_codec("auto", cuda) == "full"
    assert T.resolve_codec(None, "cpu") == "off"


@pytest.mark.parametrize("alpha,link_bw", [(0.0, 1e6), (7.52e-4, 3.68e10),
                                           (1e-9, 1e15), (1.0, 1e9)])
def test_overlap_false_alone_picks_one_segment(monkeypatch, alpha, link_bw):
    """With ``overlap=False`` (the ``cuda`` row's) the pick is S=1 whatever
    alpha and link_bw a fit gives: the fitted constants never decide it."""
    monkeypatch.setattr(CostModel, "_MEASURED", {})
    CostModel.register_calibration("cuda", alpha=alpha, link_bw=link_bw,
                                   overlap=False)
    cuda = torch.device("cuda", 0)
    for dims in TORI.values():
        _, pspec = specs(dims)["pipelined"]
        for elems in (1, 1 << 19, FULL):
            assert T.auto_segments(pspec, elems, cuda) == 1


def test_timing_does_not_load_the_train_entry_point():
    """The timer and the trace exporter sit below the entry points: they
    take the device check from ``core.device``, not ``launch.train``."""
    import subprocess
    import sys
    from conftest import SRC
    code = ("import sys\n"
            "import repro_torch.telemetry.timing\n"
            "import repro_torch.telemetry.trace\n"
            "bad = [m for m in sys.modules if m.startswith(\n"
            "    ('repro_torch.launch', 'repro_torch.models'))]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC,
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr


def test_register_measured_keeps_the_structural_constants(monkeypatch):
    monkeypatch.setattr(CostModel, "_MEASURED", {})
    wires, secs = FIT_CASES["line"]
    row = tim.register_measured(wires, secs)
    assert row == {"backend": "cuda", **jtim.fit_calibration(wires, secs)}
    cm = CostModel.for_backend("cuda")
    assert (cm.alpha, cm.link_bw) == (row["alpha"], row["link_bw"])
    assert cm.overlap is False
    tim.register_measured(wires, secs, backend="cpu")
    assert dataclasses.asdict(CostModel.for_backend("cpu")) == {
        **dataclasses.asdict(CostModel(**CostModel._BUILTIN["cpu"])),
        "alpha": row["alpha"], "link_bw": row["link_bw"]}


def test_telemetry_package_exposes_trace_and_timing():
    import repro_torch.telemetry as tel
    assert tel.trace is ttr and tel.timing is tim
    assert set(tel.__all__) == {"metrics", "trace", "timing"}
    with pytest.raises(AttributeError):
        tel.nothing


def test_wave_scopes_open_only_under_a_profiler():
    """A wave's ``edst/`` range exists only while a profiler records (one
    a wave of the program), so an unprofiled allreduce pays nothing for
    it, as the reference's trace-time ``named_scope`` pays nothing."""
    from contextlib import nullcontext
    _, spec = specs(TORI["torus4x4"])["pipelined"]
    fabric = StackedFabric(16, "cpu")
    x = torch.ones((16, 33))
    assert isinstance(T._scope("edst/t0/w0/reduce"), nullcontext)
    for enabled, want in ((True, len(spec.waves)), (False, 0)):
        prev = T.set_wave_scopes(enabled)
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                T.pipelined_tree_allreduce(x, spec, fabric, segments=1)
        finally:
            T.set_wave_scopes(prev)
        names = [e.name for e in p.events() if e.name.startswith("edst/")]
        assert len(names) == want, names
