"""Pure-Python core: the paper's star-product EDST theory and the
pipelined allreduce schedules (own copies of the reference's modules)."""
