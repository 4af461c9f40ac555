"""The flash attention kernel at head_dim 128 in the three GQA layouts the
qkv-bias / qk-norm LMs and the MoE models serve with, on the card (marked
``gpu``; it skips without a CUDA device): G = 7 (qwen2-7b, 28 heads over
4 KV heads), G = 4 (qwen3-8b and mistral-nemo-12b, 32 over 8) and G = 1
(olmoe-1b-7b and qwen2-moe-a2.7b, 16 over 16), at reduced sequence
lengths, ragged and whole.  bf16 runs on the tensor cores and is held to
2e-2 and the per-element bound of its roundings, f32 on the CUDA cores to
2e-5 (the reference's kernel-test tolerances).  This file imports neither
JAX nor the reference:

    python -m pytest -q tests/test_torch_flash_d128_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                      bf16_kernel_bound)

LAYOUTS = {"g7": (28, 4), "g4": (32, 8), "g1": (16, 16)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("b,s", [(2, 512), (1, 333), (3, 129), (2, 18)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d128_layouts_on_card(layout, b, s, dtype):
    dev = _cuda()
    h, kv = LAYOUTS[layout]
    g = torch.Generator(device=dev).manual_seed(s + h)
    q = torch.randn((b, s, h, 128), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, kv, 128), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, kv, 128), generator=g, device=dev).to(dtype)
    FK.reset_launches()
    out = fops.attention(q, k, v, causal=True)
    assert FK.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=True)
    err = (out.float() - ref.float()).abs()
    assert float(err.max()) < (2e-5 if dtype == torch.float32 else 2e-2)
    if dtype == torch.bfloat16:
        bound = bf16_kernel_bound(q, k, v, ref, causal=True)
        assert bool((err <= bound).all()), float((err / bound).max())
