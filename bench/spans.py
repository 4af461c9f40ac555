"""The program's own spans in a traced slice: device time launched inside
the train step's passes, AdamW and the fabric, and the device's idle time
under the per-vertex loop.

The program opens ``step/forward/v{v}``, ``step/backward/v{v}``,
``step/rows/v{v}``, ``step/sync`` and ``step/optim`` in its train step and
``fabric/zero``, ``fabric/gather`` and ``fabric/p2p`` in its fabric
(``repro_torch.telemetry.spans``), only while a profiler records.
:func:`summarize` is ``tracecut.summarize`` with these prefixes added to
``edst/`` and one key more, ``idle_in``: each prefix's device-idle seconds
of the slice that overlap the union of its ranges.  :func:`numbers` reads
from it what five per-layer metrics of these spans would report; on a
program without the spans it reads nothing.

    python3 bench/spans.py --workload <name> --seed <n> --seconds <s>

runs one cell as ``bench/run.py --trace 1`` does (the same result line)
and then prints one JSON line more: the five numbers, ``launched_in``,
``idle_in`` and the slice's busy and whole seconds.
"""
from __future__ import annotations

import json
import sys
from contextlib import contextmanager

import harness
import tracecut

FORWARD, BACKWARD, ROWS = "step/forward/", "step/backward/", "step/rows/"
OPTIM, FABRIC, P2P = "step/optim", "fabric/", "fabric/p2p"
LOOP = (FORWARD, BACKWARD, ROWS)
PREFIXES = LOOP + (OPTIM, FABRIC, P2P)

_base_summarize = tracecut.summarize


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(events: list, prefixes=PREFIXES) -> dict | None:
    """``{prefix: seconds}``: the device-idle time of the slice (device
    work placed on the device's timeline as ``tracecut.summarize`` places
    it for ``busy_s``) inside the union of the ranges whose names start
    with each prefix."""
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    slice_ = next((e for e in host if e["name"] == tracecut.SLICE), None)
    if slice_ is None:
        return None
    lo, hi = slice_["ts"], slice_["ts"] + slice_["dur"]
    busy = tracecut._union(
        (max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in events
        if e.get("cat") in tracecut.DEVICE_CATS and lo <= e["ts"] <= hi)
    out = {}
    for prefix in prefixes:
        spans = tracecut._union(
            (max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in host
            if e["name"].startswith(prefix) and lo <= e["ts"] <= hi)
        whole = sum(b - a for a, b in spans)
        out[prefix] = (whole - _overlap(spans, busy)) / 1e6
    return out


def summarize(events: list, range_prefixes=("edst/",), top: int = 10):
    """``tracecut.summarize`` over ``range_prefixes`` and the program's
    span prefixes, with ``idle_in``; every key ``tracecut.summarize``
    returns reads as it does there."""
    wanted = tuple(range_prefixes) + tuple(
        p for p in PREFIXES if p not in range_prefixes)
    out = _base_summarize(events, wanted, top)
    if out is not None:
        out["idle_in"] = idle_in(events)
    return out


def numbers(kind: str, summary) -> dict:
    """What the spans' per-layer metrics would read, in ms a traced unit
    (a step or a call); a number that reads 0 (a program without the
    spans, a stacked fabric's ``fabric/p2p``) is left out.

    * train: ``model_ms_per_step.train`` (launched inside the forward and
      backward passes), ``optim_ms_per_step.train`` (inside
      ``step/optim``), ``loop_idle_ms_per_step.train`` (the device idle
      inside the per-vertex loop's passes and row copies);
    * allreduce: ``fabric_ms_per_call.sync`` (inside ``fabric/``) and
      ``p2p_ms_per_call.sync`` (inside ``fabric/p2p``)."""
    if not summary or not summary["units"] or "idle_in" not in summary:
        return {}
    per = 1e3 / summary["units"]
    got, idle = summary["launched_in"], summary["idle_in"]
    if kind == "train":
        out = {"model_ms_per_step.train": got[FORWARD] + got[BACKWARD],
               "optim_ms_per_step.train": got[OPTIM],
               "loop_idle_ms_per_step.train": sum(idle[p] for p in LOOP)}
    elif kind == "allreduce":
        out = {"fabric_ms_per_call.sync": got[FABRIC],
               "p2p_ms_per_call.sync": got[P2P]}
    else:
        return {}
    return {k: v * per for k, v in out.items() if v}


@contextmanager
def recorded():
    """Inside, the kinds' ``tracecut.summarize`` is :func:`summarize`;
    yields the list of the summaries made."""
    seen = []

    def recording(events, range_prefixes=("edst/",), top=10):
        seen.append(summarize(events, range_prefixes, top))
        return seen[-1]

    tracecut.summarize = recording
    try:
        yield seen
    finally:
        tracecut.summarize = _base_summarize


def main(argv=None) -> int:
    import run as bench_run
    args = bench_run.parser().parse_args(argv)
    _, _, traffic = harness.find_cell(harness.load_benchmark(),
                                      args.workload)
    with recorded() as seen:
        code = bench_run.main(["--workload", args.workload,
                               "--seed", str(args.seed),
                               "--seconds", str(args.seconds),
                               "--trace", "1"])
    s = seen[0] if seen else None
    keep = ("units", "window_s", "busy_s", "launched_s", "launched_in",
            "idle_in")
    print(json.dumps({"workload": args.workload,
                      "spans": numbers(traffic["kind"], s),
                      **({k: s[k] for k in keep} if s else {})}),
          flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
