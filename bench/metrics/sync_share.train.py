"""Device time launched inside the program's ``edst/`` wave ranges over
the traced slice's length, in %."""


def read(ctx):
    t = ctx["trace"]
    if ctx["kind"] != "train" or not t or not t["launched_in"].get("edst/"):
        return None
    return 100.0 * t["launched_in"]["edst/"] / t["window_s"]
