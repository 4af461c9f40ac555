"""The ``lm`` model family (dense, no MoE) and the ``rglru`` family
(recurrentgemma)."""
