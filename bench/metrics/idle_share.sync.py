"""Share of the traced slice with no kernel, copy or fill on the card,
in % (the allreduce cells)."""
from readers import idle_share


def read(ctx):
    return idle_share(ctx, "allreduce")
