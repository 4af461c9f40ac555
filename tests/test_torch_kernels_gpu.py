"""The CUDA tree-combine and int8 wire-codec kernels against their plain
PyTorch versions, on the card (marked ``gpu``; they skip without a CUDA
device).  This file imports neither JAX nor the reference, so it runs on a
machine that has only PyTorch:

    python -m pytest -q tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.tree_combine import kernel as K
from repro_torch.kernels.tree_combine import ref as tref


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nch,l", [(1, 1 << 20), (3, 1000), (5, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_tree_combine_kernel_on_card(nch, l, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    recv = torch.randn((nch, l), generator=g, device=dev).to(dtype)
    part = torch.randn((l,), generator=g, device=dev).to(dtype)
    out = K.tree_combine(recv, part)
    ref = tref.tree_combine_ref(recv, part).float()
    # f32: children may be summed in another order; bf16/f16: one rounding
    # of the f32 sum, at most one ulp of the largest value
    scale = max(1.0, float(ref.abs().max()))
    tol = scale * (1e-6 if dtype == torch.float32 else 2.0 ** -7)
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", [(16, 1 << 20), (3, 257), (1, 5),
                                    (32, 4099)])
def test_q8_kernels_on_card(rows, m):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((rows, m), generator=g, device=dev) * 3.3
    w = K.q8_pack_rows(x)
    assert torch.equal(w, tref.q8_pack_rows_ref(x))
    part = torch.randn((rows, m), generator=g, device=dev)
    assert float((K.q8_combine_rows(w, part)
                  - tref.q8_combine_rows_ref(w, part)).abs().max()) <= 1e-6
    assert float((K.q8_unpack_rows(w)
                  - tref.q8_unpack_rows_ref(w)).abs().max()) <= 1e-6
    assert bool((K.q8_unpack_rows(torch.zeros_like(w)) == 0).all())
