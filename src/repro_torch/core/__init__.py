"""Pure-Python core: the paper's star-product EDST theory and the
allreduce schedule compilers (own copies of the reference's modules)."""
