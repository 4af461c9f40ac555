"""Device time a traced step spends outside the sync: the device work
launched inside the traced steps but outside the program's ``edst/``
wave ranges (the models, the optimizer, the fabric set-up), per step,
in ms."""


def read(ctx):
    t = ctx["trace"]
    if ctx["kind"] != "train" or not t or not t["units"] \
            or not t["launched_s"]:
        return None
    return 1e3 * (t["launched_s"] - t["launched_in"]["edst/"]) / t["units"]
