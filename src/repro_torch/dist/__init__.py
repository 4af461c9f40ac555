"""Data-parallel training over the EDST allreduce: the stacked fabric,
the pipelined engine and the train step."""
