"""Causal (or full) GQA softmax attention with an optional sliding window,
forward only, in CUDA C++ for sm_90a (``csrc/flash_attention.cu``), with
its plain PyTorch version (``ref``) and the device dispatch (``ops``)."""
