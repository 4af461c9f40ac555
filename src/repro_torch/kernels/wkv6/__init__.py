"""The RWKV-6 chunked WKV recurrence, in CUDA C++ for sm_90a
(``csrc/wkv6.cu``), with its plain PyTorch version (``ref``) and the
device dispatch (``ops``)."""
