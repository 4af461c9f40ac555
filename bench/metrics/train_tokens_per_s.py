"""Training tokens of every step completed in the window, over the
window's time from its first step's start to its last step's end."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["window"]["tokens"] / ctx["window"]["seconds"]
