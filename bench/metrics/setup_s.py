"""Set-up time: process start to the window's start (imports, the
kernels' build where it is not yet cached, the spec's compile, the
weights or rows, and the warm-up steps or calls)."""


def read(ctx):
    return ctx["setup_s"]
