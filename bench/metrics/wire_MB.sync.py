"""Wire bytes one allreduce of one vertex's payload ships, as the program
notes them when it first runs its compiled program (the
``edst_wire_bytes`` gauge of ``repro_torch.telemetry.metrics``), in MB."""


def read(ctx):
    b = ctx["counts"].get("wire_bytes")
    if ctx["kind"] != "allreduce" or not b:
        return None
    return b / 1e6
