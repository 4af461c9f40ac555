"""The 90th percentile of every allreduce of the window, each timed by
CUDA events around the call (across cards, its slowest rank's)."""
import statistics


def read(ctx):
    if ctx["kind"] != "allreduce":
        return None
    ms = ctx["window"]["call_ms"]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
