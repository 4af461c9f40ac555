"""The benchmark's shared plumbing: find a cell and its files by the names
``BENCHMARK.json`` gives them, load the kind that runs its traffic and the
readers of its metrics, check what the process has imported, and print
the result line.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own under this directory:

  * ``configs/<config>.json``: the configuration as it is run;
  * ``traffic/<traffic>.json``: the traffic's parameters, whose ``kind``
    names the general generator and driver in ``kinds/<kind>.py``;
  * ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning
    the value or ``None`` where it finds nothing to read;
  * ``limits/<workload>.json``: the limit of each number the cell's
    correctness check compares.

Nothing here imports the program; the kinds import it when a cell runs.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names no run may hold once its window has closed: JAX,
# and the JAX package with the harness that measured it
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def program_path() -> None:
    """Put the checkout's ``src`` first on ``sys.path``, so that the
    program under test is the checkout's own, and keep the program's
    kernel builds in the checkout's ``build/kernels`` (a fixed path, so
    that only a checkout's first run builds them)."""
    import os
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def log(t0: float, msg: str) -> None:
    """A progress line on standard error, with the seconds since ``t0``."""
    import time
    print(f"[bench {time.perf_counter() - t0:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str, root: Path = ROOT):
    """``(cell, config, traffic)`` of the workload ``name``: its entry in
    ``workloads``, its configuration file's contents and its traffic
    file's contents."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(cells))})")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / confs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def limits_for(workload: str) -> dict:
    """The limits of the numbers the cell's correctness check compares."""
    return load_json(BENCH / "limits" / f"{workload}.json")


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: its end-to-end metrics, or with
    ``trace`` its per-layer ones.  A metric with a ``workloads`` key
    belongs to the cells it lists, one without it to every cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise SystemExit(f"bench: cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str):
    """The module of ``kinds/<kind>.py``: the generator and driver of a
    traffic kind (``run(...)``), imported by name, so that the ranks it
    spawns can import it too."""
    if not (BENCH / "kinds" / f"{kind}.py").exists():
        raise SystemExit(f"bench: no traffic kind {kind!r}")
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    return importlib.import_module(f"kinds.{kind}")


def load_reader(metric: str):
    """The reader of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        raise SystemExit(f"bench: no reader for metric {metric!r} ({path})")
    return _load_file(path, "bench_metric_" + metric.replace(".", "_")
                      .replace("-", "_"))


def read_metrics(entries: list, ctx) -> dict:
    """``{name: {"value", "unit"}}`` of each entry whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = load_reader(m["name"]).read(ctx)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise SystemExit(f"bench: metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_record(dev, count: int, peak: int, summary=None) -> dict:
    """The result line's ``device``: the platform and card, the cards
    used, the peak on the fullest, and for a traced run the slice's busy
    and whole seconds."""
    import torch
    cuda = dev.type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "count": count, "memory_peak_bytes": int(peak)}
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
    return out


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def check_lines(checks: list) -> list:
    """One line a compared number: its short name, value and limit."""
    return [f"check {name}: {value!r} (limit {limit!r})"
            for name, value, limit in checks]


def checks_json(checks: list) -> dict:
    return {name: {"value": value, "limit": limit}
            for name, value, limit in checks}


def within(checks: list) -> bool:
    """Whether every compared number is finite and within its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks_json(checks)
    return json.dumps(out)
