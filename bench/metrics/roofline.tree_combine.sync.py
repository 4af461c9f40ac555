"""``tree_combine``'s share of its bytes roofline in the traced slice
(the allreduce cells), in %."""
from readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "allreduce", r"tree_combine_kernel",
                           "combine_bytes_per_unit")
