"""Data-parallel training over the EDST allreduce: the stacked fabric,
the engines (pipelined, fused, per-tree in ``tree_allreduce``, striped in
``striped``) and the train step."""
