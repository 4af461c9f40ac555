"""Telemetry of the port (the reference's ``repro.telemetry``, module for
module):

  * :mod:`repro_torch.telemetry.metrics` -- process-wide counters /
    gauges / histograms with JSON and Prometheus-text export;
  * :mod:`repro_torch.telemetry.trace`   -- Chrome-trace-event (Perfetto)
    export of any compiled wave program, predicted (CostModel) or
    measured timings;
  * :mod:`repro_torch.telemetry.timing`  -- the wave-by-wave timer on a
    stacked fabric: per-wave measured durations, residuals against the
    CostModel's predictions, and calibration fitting;
  * :mod:`repro_torch.telemetry.spans`   -- the profiler ranges around
    the train step's passes, the optimizer and the fabric's copies.

``spans`` is the port's own (the reference's ranges are ``named_scope``s
of its traced programs), imported by the modules that open them.
``metrics`` is pure stdlib and imported eagerly; ``trace`` and ``timing``
load on first use (``timing`` imports torch and the engines, which import
``metrics``).
"""
from __future__ import annotations

from . import metrics  # noqa: F401  (stdlib-only, always safe)

__all__ = ("metrics", "trace", "timing")


def __getattr__(name):
    if name in ("trace", "timing"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
