"""Chrome-trace-event export of compiled wave programs, for Perfetto (the
port's copy of the reference's ``repro.telemetry.trace``).

Renders ANY compiled spec -- per-tree, fused, pipelined, striped, and
whole fault-runtime entry tables -- as Chrome Trace Event Format JSON
(load in https://ui.perfetto.dev or ``chrome://tracing``):

  * one *lane* per device (``lane="device"``, the default: tid = vertex
    id, spans sit on the sender's lane) or per tree (``lane="tree"``);
  * one *span* (``ph: "X"``) per message, all of a wave's spans sharing
    the wave's start/duration; ``args`` carry the wave index, tree, op
    kind, wire bytes and segment index;
  * *flow events* (``ph: "s"`` / ``"f"``, matched ids) along the
    recovered happens-before DAG: message ``(s -> d, tree j)`` depends
    on the latest earlier wave's arrivals at ``s`` in tree ``j`` --
    exactly the data dependence the static verifier
    (:mod:`repro_torch.analysis.verify`) re-derives from the routing
    tables (children's reduces before the parent's, the root's last
    reduce before its first broadcast, RS before AG on the striped
    engine).

Timings are *predicted* by default -- each wave lasts ``alpha +
wire_bytes / link_bw`` under the (deterministic) default
:class:`repro_torch.core.collectives.CostModel`, so traces are
byte-stable and golden-diffable, and equal to the reference's apart from
``otherData.generator`` -- or *measured* when per-wave durations from
:mod:`repro_torch.telemetry.timing` are passed via ``wave_times``.

Pure NumPy + stdlib (the verifier's scanners do the message recovery);
only ``--measured`` imports torch, through the timer.

    PYTHONPATH=src python -m repro_torch.telemetry.trace \
        --topology slimfly --engine striped --out trace.json
    PYTHONPATH=src python -m repro_torch.telemetry.trace \
        --topologies paper5 --all-engines --out-dir traces/ --validate
    PYTHONPATH=src python -m repro_torch.telemetry.trace \
        --engine striped --measured --out trace.json     # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.collectives import (BCAST, REDUCE, CostModel,
                                StripedCollectiveSpec, striped_tables,
                                wave_wire_bytes)

DEFAULT_NBYTES = 4 << 20      # 4 MiB f32 payload: the bench's regime

_KIND_NAMES = {REDUCE: "reduce", BCAST: "bcast"}


# ---------------------------------------------------------------------------
# message recovery (one normalized form for every engine)
# ---------------------------------------------------------------------------

def spec_messages(spec, nbytes: int = DEFAULT_NBYTES, itemsize: int = 4,
                  fractions=None):
    """Normalize a compiled spec to per-wave messages.

    Returns ``(wires, msgs)``: ``wires[w]`` is wave w's wire bytes (what
    every hop of the wave ships), ``msgs`` a list of
    ``(wave, tree, op, src, dst, msg_bytes)`` in wave order, where
    ``op`` is ``reduce``/``bcast`` (chunk engines) or ``rs``/``ag``
    (striped).  Chunk engines reuse the verifier's message scanners; the
    striped engine reads its *bound* waves (empty stripe windows are
    dropped exactly as the executor drops them)."""
    from ..analysis import verify as _v

    wires = wave_wire_bytes(spec, nbytes, itemsize, fractions)
    if isinstance(spec, StripedCollectiveSpec):
        elems = max(1, -(-int(nbytes) // itemsize))
        fr = None if fractions is None else tuple(fractions)
        bound = striped_tables(spec, elems, fr)
        msgs = []
        for w, bw in enumerate(bound.waves):
            op = "rs" if bw.op == REDUCE else "ag"
            for s, d in bw.perm:
                msgs.append((w, int(bw.recv_tree[d]), op, s, d,
                             int(bw.recv_len[d]) * itemsize))
        return wires, msgs

    sink: list = []   # scanner violations; specs were verified at compile
    eng = _v.engine_of(spec)
    if eng == "pipelined":
        raw = _v._scan_pipelined(spec, spec.waves, "waves", sink)
    elif eng == "fused":
        raw = _v._scan_fused(spec, sink)
    else:
        raw = _v._scan_per_tree(spec, sink)
    msgs = [(w, j, _KIND_NAMES[kind], s, d, wires[w])
            for (w, j, kind, s, d) in sorted(raw)]
    return wires, msgs


def happens_before(msgs):
    """The recovered happens-before DAG at message granularity: edges
    ``(producer_index, consumer_index)`` into ``msgs``.  A message
    ``(s -> d, tree j)`` at wave w forwards state ``s`` accumulated on
    tree ``j``, so it depends on the arrivals at ``s`` in tree ``j``
    from the *latest* earlier wave -- the verifier's
    children-before-parent / root-reduce-before-broadcast / RS-before-AG
    rules collapse to exactly this data dependence."""
    arrivals: dict = {}            # (tree, vertex) -> [(wave, msg index)]
    for i, (w, j, _op, _s, d, _b) in enumerate(msgs):
        arrivals.setdefault((j, d), []).append((w, i))
    edges = []
    for i, (w, j, _op, s, _d, _b) in enumerate(msgs):
        earlier = [(w2, i2) for (w2, i2) in arrivals.get((j, s), ())
                   if w2 < w]
        if not earlier:
            continue
        last = max(w2 for w2, _ in earlier)
        edges.extend((i2, i) for (w2, i2) in earlier if w2 == last)
    return edges


# ---------------------------------------------------------------------------
# event building
# ---------------------------------------------------------------------------

def _round(us: float) -> float:
    return round(us, 3)


def trace_events(spec, nbytes: int = DEFAULT_NBYTES, cost_model=None,
                 wave_times=None, fractions=None, lane: str = "device",
                 label: str | None = None, pid: int = 0,
                 flow_base: int = 0, t0_us: float = 0.0,
                 itemsize: int = 4, segment: int = 0):
    """Chrome trace events for one compiled spec (list of dicts).

    ``wave_times`` overrides the predicted per-wave durations with
    measured seconds (same length as the program's wave count);
    ``pid``/``flow_base``/``t0_us`` offset lanes, flow ids and time so
    several specs (a fault runtime's entries) compose into one trace."""
    if lane not in ("device", "tree"):
        raise ValueError(f"lane {lane!r} not in ('device', 'tree')")
    cm = cost_model or CostModel()
    wires, msgs = spec_messages(spec, nbytes, itemsize, fractions)
    times = tuple(wave_times) if wave_times is not None \
        else cm.wave_times(spec, nbytes, itemsize, fractions)
    if len(times) != len(wires):
        raise ValueError(f"{len(times)} wave times for a "
                         f"{len(wires)}-wave program")

    starts, t = [], t0_us
    for sec in times:
        starts.append(t)
        t += sec * 1e6

    label = label or f"edst/{getattr(spec, 'k', 0)}-tree"
    events = [{"name": "process_name", "ph": "M", "ts": 0.0, "pid": pid,
               "tid": 0, "args": {"name": label}}]
    lanes = sorted({(s if lane == "device" else j)
                    for (_w, j, _op, s, _d, _b) in msgs})
    for t_id in lanes:
        events.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                       "pid": pid, "tid": int(t_id),
                       "args": {"name": (f"dev{t_id}" if lane == "device"
                                         else f"tree{t_id}")}})

    spans = []
    for (w, j, op, s, d, mbytes) in msgs:
        tid = s if lane == "device" else j
        spans.append({
            "name": f"t{j}/{op}", "cat": "wave", "ph": "X",
            "ts": _round(starts[w]), "dur": _round(times[w] * 1e6),
            "pid": pid, "tid": int(tid),
            "args": {"wave": w, "tree": j, "kind": op, "src": s, "dst": d,
                     "bytes": mbytes, "wire_bytes": wires[w],
                     "segment": segment},
        })
    events.extend(spans)

    for fid, (i2, i) in enumerate(happens_before(msgs)):
        prod, cons = spans[i2], spans[i]
        fid += flow_base
        events.append({"name": "dep", "cat": "hb", "ph": "s", "id": fid,
                       "ts": _round(prod["ts"] + prod["dur"]),
                       "pid": pid, "tid": prod["tid"]})
        events.append({"name": "dep", "cat": "hb", "ph": "f", "bp": "e",
                       "id": fid, "ts": _round(max(cons["ts"],
                                                   prod["ts"] + prod["dur"])),
                       "pid": pid, "tid": cons["tid"]})
    return events


def chrome_trace(events, **other) -> dict:
    """Wrap events in the Chrome Trace Event Format envelope, metadata
    first, the rest sorted by timestamp (the writer's monotonic-``ts``
    guarantee the validator checks)."""
    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["ts"], e["pid"], e["tid"]))
    return {"traceEvents": meta + rest, "displayTimeUnit": "ms",
            "otherData": {"generator": "repro_torch.telemetry.trace",
                          **other}}


def trace_spec(spec, **kw) -> dict:
    """One compiled spec -> a complete Chrome trace dict."""
    return chrome_trace(trace_events(spec, **kw))


def trace_runtime(runtime, nbytes: int = DEFAULT_NBYTES, cost_model=None,
                  lane: str = "device", itemsize: int = 4) -> dict:
    """A fault runtime's whole entry table in one trace: one process
    lane group per precompiled failure class (``sid0/full``,
    ``sid1/degraded-tree0``, ...), each rendered with its own weighted
    stripe fractions.  k=0 entries (nothing to run) are skipped."""
    events, flow_base = [], 0
    for i, e in enumerate(runtime.entries):
        if e.k == 0:
            continue
        evs = trace_events(e.spec, nbytes=nbytes, cost_model=cost_model,
                           fractions=e.fractions or None, lane=lane,
                           label=f"sid{i}/{e.name}", pid=i,
                           flow_base=flow_base, itemsize=itemsize)
        flow_base += sum(1 for ev in evs if ev["ph"] == "s")
        events.extend(evs)
    return chrome_trace(events, entries=len(runtime.entries))


def write_trace(path, trace: dict) -> None:
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
        f.write("\n")


# ---------------------------------------------------------------------------
# schema validation (the CI gate and the test suite's oracle)
# ---------------------------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_PHASES = ("X", "s", "f", "M")


def validate_trace(trace) -> list:
    """Chrome-trace schema violations (empty list == valid):

      * envelope: a dict with a non-empty ``traceEvents`` list;
      * every event carries name/ph/ts/pid/tid; ``X`` spans also a
        non-negative ``dur`` and an ``args`` dict; ``ts`` never negative;
      * monotonic ``ts``: non-metadata events sorted by timestamp, and
        per (pid, tid) lane timestamps never decrease;
      * matched flows: every flow id appears exactly once as ``"s"`` and
        once as ``"f"``, with the finish no earlier than the start.
    """
    out = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["envelope: not a dict with a 'traceEvents' key"]
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["envelope: 'traceEvents' is not a non-empty list"]

    last_ts = None
    lane_ts: dict = {}
    flows: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            out.append(f"event[{i}]: not a dict")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            out.append(f"event[{i}]: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            out.append(f"event[{i}]: unknown phase {ph!r}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            out.append(f"event[{i}]: bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                out.append(f"event[{i}]: X span with bad dur "
                           f"{ev.get('dur')!r}")
            if not isinstance(ev.get("args"), dict):
                out.append(f"event[{i}]: X span without args")
        if last_ts is not None and ts < last_ts:
            out.append(f"event[{i}]: ts {ts} decreases (prev {last_ts})")
        last_ts = ts
        lane = (ev["pid"], ev["tid"])
        if lane in lane_ts and ts < lane_ts[lane]:
            out.append(f"event[{i}]: lane {lane} ts {ts} decreases")
        lane_ts[lane] = ts
        if ph in ("s", "f"):
            if "id" not in ev:
                out.append(f"event[{i}]: flow event without id")
                continue
            flows.setdefault(ev["id"], {}).setdefault(ph, []).append(ts)

    for fid in sorted(flows):
        f = flows[fid]
        if len(f.get("s", ())) != 1 or len(f.get("f", ())) != 1:
            out.append(f"flow {fid}: needs exactly one 's' and one 'f' "
                       f"(got {len(f.get('s', ()))}/{len(f.get('f', ()))})")
        elif f["f"][0] < f["s"][0]:
            out.append(f"flow {fid}: finish ts {f['f'][0]} before start "
                       f"ts {f['s'][0]}")
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _resolve_topologies(args) -> list:
    from ..analysis.verify import PAPER_TOPOLOGIES
    if args.topologies:
        if args.topologies == "paper5":
            return list(PAPER_TOPOLOGIES)
        return args.topologies.split(",")
    if not args.topology:
        return ["torus4x4"]
    hits = [t for t in PAPER_TOPOLOGIES
            if t == args.topology or t.startswith(args.topology)]
    if len(hits) != 1:
        raise SystemExit(f"--topology {args.topology!r} matches {hits} "
                         f"(known: {', '.join(PAPER_TOPOLOGIES)})")
    return hits


def _out_path(args, label: str, engine: str) -> str:
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        return os.path.join(args.out_dir, f"trace_{label}_{engine}.json")
    return args.out or f"trace_{label}_{engine}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.trace",
        description=__doc__.splitlines()[0])
    ap.add_argument("--topology", default=None,
                    help="paper topology (unambiguous prefixes accepted, "
                         "e.g. 'slimfly'); default torus4x4")
    ap.add_argument("--topologies", default=None,
                    help="'paper5' or a comma list (overrides --topology)")
    ap.add_argument("--engine", default="pipelined",
                    help="per_tree | fused | pipelined | striped")
    ap.add_argument("--all-engines", action="store_true")
    ap.add_argument("--out", default=None,
                    help="output path (single topology x engine)")
    ap.add_argument("--out-dir", default=None,
                    help="directory for trace_<topology>_<engine>.json "
                         "(multi-case runs)")
    ap.add_argument("--nbytes", type=int, default=DEFAULT_NBYTES)
    ap.add_argument("--lane", choices=("device", "tree"), default="device")
    ap.add_argument("--validate", action="store_true",
                    help="schema-validate every written trace (exit 1 on "
                         "any violation)")
    ap.add_argument("--measured", action="store_true",
                    help="time each wave on --device with the wave-by-"
                         "wave timer (imports torch; pipelined/striped "
                         "only) instead of using CostModel predictions")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --measured (default cuda: "
                         "without a CUDA device it exits non-zero; cpu "
                         "times on the host)")
    args = ap.parse_args(argv)

    if args.measured:
        from ..core.device import resolve_device
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"[trace] --measured: {e}") from None

    from ..analysis.verify import _compile_specs, _schedule_for
    engines = (("per_tree", "fused", "pipelined", "striped")
               if args.all_engines else (args.engine,))
    topologies = _resolve_topologies(args)

    failed = 0
    for label in topologies:
        sched = _schedule_for(label)
        specs = _compile_specs(sched, engines)
        for engine in engines:
            spec = specs[engine]
            if isinstance(spec, str):
                print(f"[trace] {label}/{engine}: SKIP ({spec})")
                continue
            wave_times = None
            if args.measured:
                if engine not in ("pipelined", "striped"):
                    print(f"[trace] {label}/{engine}: SKIP measured mode "
                          "(pipelined/striped only)")
                    continue
                from .timing import measured_wave_times
                wave_times = measured_wave_times(spec, nbytes=args.nbytes,
                                                 device=args.device)
            trace = trace_spec(spec, nbytes=args.nbytes, lane=args.lane,
                               label=f"{label}/{engine}",
                               wave_times=wave_times)
            path = _out_path(args, label, engine)
            write_trace(path, trace)
            nspans = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
            note = ""
            if args.validate:
                violations = validate_trace(trace)
                if violations:
                    failed += 1
                    note = f"  INVALID ({len(violations)} violations)"
                    for v in violations[:5]:
                        print(f"  [trace]   {v}")
                else:
                    note = "  schema OK"
            print(f"[trace] {label}/{engine}: {nspans} spans, "
                  f"{sum(1 for e in trace['traceEvents'] if e['ph'] == 's')}"
                  f" flows -> {path}{note}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
