"""``BENCHMARK.json`` against the benchmark's contract, and the last line
a run prints, from a run of each kind at a tiny size on the CPU."""
import io
import json
import re
from contextlib import redirect_stdout

import pytest

import harness
import run as bench_run
from bench_tiny import TINY_RUNS, tiny_result

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit \
        and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench/") and c["file"] not in files
        files.add(c["file"])
        conf = harness.load_json(harness.ROOT / c["file"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert key in conf.get("published", {}), key


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4) and _line(c["why"])
        _, _, traffic = harness.find_cell(bench, c["name"])
        assert (harness.BENCH / "kinds" / f"{traffic['kind']}.py").exists()
        assert harness.limits_for(c["name"])


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"].split(",")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in bench["workloads"]:
        mine = [m["name"] for m in harness.metrics_for(bench, c["name"],
                                                       False)]
        assert "setup_s" in mine and len(mine) >= 2
        per = harness.metrics_for(bench, c["name"], True)
        assert per and all(m["moves"] in mine for m in per)


def test_run_budget(bench):
    """A full check of 24 cells fits the driver's 43200 seconds."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind,trace", [(k, t) for k in TINY_RUNS
                                        for t in (False, True)])
def test_result_line(kind, trace):
    """The last line of a run: its keys, the metrics of the cell's group
    with units, the device record, and the checks last."""
    bench, name, res = tiny_result(kind, trace)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench_run.report(bench, name, trace, res) == 0
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = list(last)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert last["correct"] is True and last["attempted"] >= 1
    want = {m["name"] for m in harness.metrics_for(bench, name, trace)}
    assert set(last["metrics"]) <= want
    if not trace:
        assert set(last["metrics"]) == want
    for v in last["metrics"].values():
        assert set(v) == {"value", "unit"} and isinstance(v["value"], float)
    dev = last["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev and "window_s" in dev) == trace
    assert ("breakdown" in last) == trace
    for c in last["checks"].values():
        assert set(c) == {"value", "limit"}
