"""The ``lm`` model family (dense, no MoE)."""
