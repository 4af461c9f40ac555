"""The RG-LRU scan ``h_t = a_t * h_{t-1} + b_t``, in CUDA C++ for sm_90a
(``csrc/rglru.cu``), with its plain PyTorch version (``ref``) and the
device dispatch (``ops``)."""
