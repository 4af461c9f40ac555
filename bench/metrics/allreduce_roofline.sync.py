"""The whole allreduce's least time over its measured time, in %.  The
least time follows from the result alone (``counts.
allreduce_least_seconds``): every local row read once and every local
output row written once at HBM speed, and across cards 2 (W - 1) / W of
one card's reduced payload over one NVLink direction, the larger of the
two; the measured time is the window's mean call time."""
import statistics

import counts


def read(ctx):
    if ctx["kind"] != "allreduce":
        return None
    c = ctx["counts"]
    least, _ = counts.allreduce_least_seconds(c["rows"], c["width"],
                                              ctx["world"])
    mean_s = statistics.fmean(ctx["window"]["call_ms"]) / 1e3
    return 100.0 * least / mean_s
