"""Algorithm bandwidth: one vertex's payload bytes times the allreduces
completed in the window, over the window's time (NCCL's algbw)."""


def read(ctx):
    if ctx["kind"] != "allreduce":
        return None
    w = ctx["window"]
    return w["payload_bytes"] * w["count"] / w["seconds"] / 1e9
