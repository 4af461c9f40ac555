"""PyTorch + CUDA port of the EDST star-product training stack.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor of JAX).  The first slice covers the data-parallel training
path whose gradient sync is the pipelined EDST allreduce: the core
schedules (:mod:`repro_torch.core`), the tree-combine and int8 wire-codec
kernels (:mod:`repro_torch.kernels.tree_combine`), a stacked one-device
fabric (:mod:`repro_torch.dist.fabric`), the ``lm`` model family, AdamW
and the training entry point (:mod:`repro_torch.launch.train`).  The
second slice is serving (:mod:`repro_torch.launch.serve`): the ``lm`` and
``rglru`` families' prefill and decode, with the flash attention and
RG-LRU scan kernels (:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.rglru`).  Later slices serve ``rwkv6``
(:mod:`repro_torch.kernels.wkv6`) and add every EDST engine of the
reference with its spec compilers (:mod:`repro_torch.dist.tree_allreduce`,
:mod:`repro_torch.dist.striped`) and the metrics registry
(:mod:`repro_torch.telemetry`).
"""
