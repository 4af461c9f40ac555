"""Arithmetic shared by the metric readers of ``metrics/``."""
import peaks
import tracecut


def idle_share(ctx, kind):
    """The share of the traced slice in which no kernel, copy or fill ran
    on the card, in %."""
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline(ctx, kind, pattern, bytes_key):
    """A kernel's least time over its device time in the traced slice, in
    %.  The least time is the kernel's bytes, each input byte read once
    and each output byte written once (from the program's own launches
    over one untimed unit: a step or a call), times the units traced,
    over the HBM's bandwidth; its operations (one add an element) take
    far less than its bytes, so the bytes bind."""
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or not t["units"]:
        return None
    seconds, launches = tracecut.kernel_seconds(t, pattern)
    nbytes = ctx["counts"].get(bytes_key, 0)
    if not seconds or not launches or not nbytes:
        return None
    return 100.0 * peaks.hbm_seconds(nbytes * t["units"]) / seconds
