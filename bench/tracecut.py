"""Reduce a ``torch.profiler`` trace of a traced slice to the numbers the
per-layer readers take.

The slice is one ``bench/slice`` range (``record_function``) around a few
units of work, each a ``bench/unit<i>`` range, opened by the benchmark's
own files.  Device work (kernels, copies, fills) is placed two ways: on
the device's own timeline, for busy and idle time, and by the host range
its launch falls in (the launch's correlation id), for the share launched
inside the program's ``edst/`` wave ranges.  The trace is written to a
file under ``TMPDIR``, read once and deleted.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "bench/slice"
UNIT = "bench/unit"


@contextmanager
def profiled(device_type: str):
    """A profiler over the host and, on CUDA, the device; yields it."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def events_of(prof) -> list:
    """The trace's events, through a Chrome trace file under TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(starts, evs, t):
    """The name of the innermost event of ``evs`` (sorted by start, with
    ``starts`` their starts) that covers time ``t``, or ``None``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 5000), -1):
        e = evs[j]
        if e["ts"] + e.get("dur", 0) >= t:
            return e["name"]
    return None


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _label(name):
    return None if name is None else re.sub(r"\d+", "#", name)


def summarize(events: list, range_prefixes=("edst/",), top: int = 10):
    """The slice's numbers (times in seconds):

    * ``window_s``: the ``bench/slice`` range's length; ``units``: the
      ``bench/unit*`` ranges inside it;
    * ``busy_s``: the union of device work on the device's timeline,
      clipped to the slice;
    * ``kernel_s`` / ``kernel_n``: device seconds and launches by name;
    * ``launched_s``: device seconds of the work launched inside the
      slice; ``launched_in``: of the part launched inside ranges whose
      names start with each prefix;
    * ``breakdown``: the device operations that took most time, and the
      longest idle gaps, each named by the host range and operation that
      covered its middle."""
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]
    slice_ = next((e for e in host if e["name"] == SLICE), None)
    if slice_ is None:
        return None
    lo, hi = slice_["ts"], slice_["ts"] + slice_["dur"]
    ranges = [e for e in host if e.get("cat") == "user_annotation"
              and lo <= e["ts"] <= hi]
    units = sum(1 for e in ranges if e["name"].startswith(UNIT))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    in_slice = [e for e in dev if lo <= e["ts"] <= hi]
    kernel_s, kernel_n = {}, {}
    for e in in_slice:
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + e["dur"] / 1e6
        kernel_n[e["name"]] = kernel_n.get(e["name"], 0) + 1
    busy = _union((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                  for e in in_slice)
    busy_s = sum(b - a for a, b in busy) / 1e6
    launched = [(launch_ts.get(e.get("args", {}).get("correlation")),
                 e["dur"] / 1e6) for e in dev]
    launched = [(t, d) for t, d in launched if t is not None and lo <= t <= hi]
    launched_in = {}
    for prefix in range_prefixes:
        spans = _union((e["ts"], e["ts"] + e["dur"]) for e in ranges
                       if e["name"].startswith(prefix))
        starts = [a for a, _ in spans]
        total = 0.0
        for t, d in launched:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += d
        launched_in[prefix] = total
    # idle gaps on the device timeline inside the slice
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    ann = sorted((e for e in host if e.get("cat") == "user_annotation"
                  and e["name"] != SLICE), key=lambda e: e["ts"])
    ops = sorted((e for e in host if e.get("cat") == "cpu_op"),
                 key=lambda e: e["ts"])
    ann_ts, ops_ts = [e["ts"] for e in ann], [e["ts"] for e in ops]
    idle = []
    for dur, a, b in gaps[:top]:
        mid = (a + b) / 2
        name = " | ".join(x for x in (_label(_innermost(ann_ts, ann, mid)),
                                      _label(_innermost(ops_ts, ops, mid)))
                          if x) or "host outside any range"
        idle.append([name, dur / 1e6])
    device_ops = sorted(([_short(k), v] for k, v in kernel_s.items()),
                        key=lambda kv: -kv[1])[:top]
    return {"window_s": (hi - lo) / 1e6, "units": units, "busy_s": busy_s,
            "kernel_s": kernel_s, "kernel_n": kernel_n,
            "launched_s": sum(d for _, d in launched),
            "launched_in": launched_in,
            "breakdown": {"device_ops": device_ops, "idle_gaps": idle}}


def kernel_seconds(summary: dict, pattern: str) -> tuple:
    """``(seconds, launches)`` of the device kernels whose names match
    ``pattern`` (a regular expression) in a summary."""
    rx = re.compile(pattern)
    s = sum(v for k, v in summary["kernel_s"].items() if rx.search(k))
    n = sum(v for k, v in summary["kernel_n"].items() if rx.search(k))
    return s, n
