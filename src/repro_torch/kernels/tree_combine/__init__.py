"""The EDST tree collectives' kernels: the multi-child partial-sum combine
and the int8 wire codec (pack, combine, unpack), in CUDA C++ for sm_90a
(``csrc/tree_combine.cu``), with their plain PyTorch versions (``ref``)
and the device dispatch (``ops``)."""
