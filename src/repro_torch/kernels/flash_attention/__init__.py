"""Causal (or full) GQA softmax attention with an optional sliding window,
in CUDA C++ for sm_90a (``csrc/flash_attention.cu``: the forward, and a
bf16 backward from the forward's row log-sum-exp), with its plain PyTorch
version (``ref``) and the device dispatch (``ops``)."""
