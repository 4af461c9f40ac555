"""Process-wide metrics registry: counters, gauges, histograms (the
port's copy of the reference's ``repro.telemetry.metrics``).

Pure stdlib, so every layer of the port can emit structured observations:

  * the executors (``repro_torch.dist.tree_allreduce`` / ``.striped``)
    note every compiled wave program they run -- waves, static wire
    bytes, codec selection -- once per distinct program signature (the
    port's stand-in for the reference's JAX trace: eager PyTorch has no
    trace, so the port has no retrace counter);
  * ``repro_torch.launch.train`` counts committed train steps.

Export as JSON (:func:`snapshot`) or Prometheus text exposition format
(:func:`prometheus_text`).  The registry is process-global state by
design (one process == one fabric participant); tests isolate through
:func:`reset`.
"""
from __future__ import annotations

import json
import threading

_INF = float("inf")

# default histogram buckets: seconds-scale latencies from 10us to ~2min
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """One named metric; values are kept per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict = {}

    def labeled(self) -> dict:
        """label-tuple -> value (the raw store; JSON-able for counters
        and gauges, per-bucket dicts for histograms)."""
        return dict(self._values)

    def value(self, **labels):
        """The value for one label set (0/None when never touched)."""
        return self._values.get(_label_key(labels))


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> float:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount
        return self._values[key]

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> float:
        self._values[_label_key(labels)] = float(value)
        return self._values[_label_key(labels)]

    def inc(self, amount: float = 1.0, **labels) -> float:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount
        return self._values[key]


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=None):
        super().__init__(name, help)
        bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        h = self._values.get(key)
        if h is None:
            h = {"count": 0, "sum": 0.0,
                 "buckets": [0] * (len(self.buckets) + 1)}
            self._values[key] = h
        h["count"] += 1
        h["sum"] += float(value)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                h["buckets"][i] += 1
                break
        else:
            h["buckets"][-1] += 1


class MetricsRegistry:
    """Name -> metric.  Registration is idempotent per (name, kind);
    re-registering a name as a different kind is a programming error and
    raises."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()
        # program signatures the executors have already noted (see
        # :func:`note_program`)
        self._seen_programs: set = set()

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._seen_programs.clear()

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dump: name -> {type, help, values: [{labels, value}]}.
        Histogram values carry {count, sum, buckets: {le -> count}}."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            values = []
            for key in sorted(m._values):
                val = m._values[key]
                if isinstance(m, Histogram):
                    les = [*(repr(b) for b in m.buckets), "+Inf"]
                    val = {"count": val["count"], "sum": val["sum"],
                           "buckets": dict(zip(les, val["buckets"]))}
                values.append({"labels": dict(key), "value": val})
            out[name] = {"type": m.kind, "help": m.help, "values": values}
        return out

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
            f.write("\n")

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key in sorted(m._values):
                val = m._values[key]
                if isinstance(m, Histogram):
                    cum = 0
                    for bound, cnt in zip([*m.buckets, _INF],
                                          val["buckets"]):
                        cum += cnt
                        le = "+Inf" if bound == _INF else repr(bound)
                        lines.append(f"{name}_bucket"
                                     f"{_fmt_labels(key, le=le)} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(key)}"
                                 f" {_fmt_value(val['sum'])}")
                    lines.append(f"{name}_count{_fmt_labels(key)}"
                                 f" {val['count']}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)}"
                                 f" {_fmt_value(val)}")
        return "\n".join(lines) + "\n"


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(key: tuple, **extra) -> str:
    items = [*key, *((k, str(v)) for k, v in extra.items())]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# ---------------------------------------------------------------------------
# the process-wide default registry + module-level conveniences
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def reset() -> None:
    REGISTRY.reset()


def counter_values(name: str) -> dict:
    """label-tuple -> value for one counter (empty when never touched)."""
    m = REGISTRY.get(name)
    return dict(m._values) if m is not None else {}


def note_program(engine: str, key, waves: int, wire_bytes: int,
                 codec: str | None = None) -> bool:
    """Executor hook: the first time this process runs an (engine, spec
    key, payload, codec) signature, counts the program per engine, sets
    the static program gauges (wave count, total wire bytes) and notes
    the codec selection; a repeat notes nothing.  The reference notes a
    program when JAX traces it, once per compiled program (and counts a
    repeat as a retrace); eager PyTorch runs the executor's Python on
    every call and has no trace, so the port notes the first run of each
    signature and the counters mean the same.  Returns whether it
    noted."""
    sig = (engine, key, int(wire_bytes), codec)
    if sig in REGISTRY._seen_programs:
        return False
    REGISTRY._seen_programs.add(sig)
    counter("edst_program_traces_total",
            "distinct compiled wave programs run").inc(engine=engine)
    gauge("edst_program_waves",
          "waves in the most recently noted program").set(waves,
                                                          engine=engine)
    gauge("edst_wire_bytes",
          "total predicted wire bytes of the most recently noted "
          "program").set(wire_bytes, engine=engine)
    if codec is not None:
        counter("edst_codec_selections_total",
                "wire codec selections of noted programs"
                ).inc(codec=codec)
    return True
