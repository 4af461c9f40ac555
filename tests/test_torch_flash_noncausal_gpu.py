"""The flash attention kernel in the layouts the encoder-decoder and VLM
families serve with, on the card (marked ``gpu``; it skips without a CUDA
device): full (non-causal) attention with S queries over T keys, square,
S < T, S > T and a ragged T (seamless-m4t-large-v2's encoder and its
decoder's cross-attention over the encoder's frames: 16 heads over 16,
D 64), and causal at G = 2, D = 128 (internvl2-2b: 16 heads over 8).
bf16 runs on the tensor cores and is held to 2e-2 and the per-element
bound of its roundings, f32 on the CUDA cores to 2e-5 (the reference's
kernel-test tolerances).  This file imports neither JAX nor the
reference:

    python -m pytest -q tests/test_torch_flash_noncausal_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                      bf16_kernel_bound)

# (b, s, t, h, kv, d, causal)
CASES = {"full_square": (2, 256, 256, 16, 16, 64, False),
         "full_s_lt_t": (2, 77, 128, 16, 16, 64, False),
         "full_s_gt_t": (2, 129, 64, 8, 8, 64, False),
         "full_ragged_t": (1, 50, 333, 4, 4, 64, False),
         "full_two_blocks": (1, 200, 1024, 16, 16, 64, False),
         "causal_g2_d128": (2, 301, 301, 16, 8, 128, True),
         "causal_g2_d128_small": (3, 18, 18, 16, 8, 128, True)}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_encdec_vlm_layouts_on_card(case, dtype):
    dev = _cuda()
    b, s, t, h, kv, d, causal = CASES[case]
    g = torch.Generator(device=dev).manual_seed(s + 7 * t + h)
    q = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, t, kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, t, kv, d), generator=g, device=dev).to(dtype)
    FK.reset_launches()
    out = FK.flash_attention(q, k, v, causal=causal)
    assert FK.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs()
    assert float(err.max()) < (2e-5 if dtype == torch.float32 else 2e-2)
    if dtype == torch.bfloat16:
        bound = bf16_kernel_bound(q, k, v, ref, causal=causal)
        assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_full_mask_launches_the_kernel(dtype):
    """The models' dispatch (``ops.attention``, causal=False at a
    block-aligned T) launches the kernel on CUDA tensors."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 97, 16, 64), generator=g, device=dev).to(dtype)
    k = torch.randn((2, 512, 16, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((2, 512, 16, 64), generator=g, device=dev).to(dtype)
    FK.reset_launches()
    out = fops.attention(q, k, v, causal=False)
    assert FK.LAUNCHES["flash_attention"] == 1
    ref = attention_ref(q, k, v, causal=False)
    assert float((out.float() - ref.float()).abs().max()) < \
        (2e-5 if dtype == torch.float32 else 2e-2)
