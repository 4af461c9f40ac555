"""The flash attention backward kernels on the card (marked ``gpu``; they
skip without a CUDA device), and the training path that takes them.

The bf16 backward (``flash_attention_bwd``: dq, dk and dv from q, k, v,
the forward's output and row log-sum-exp, and dO) is held against its
arithmetic in f32, ``ref.py::attention_bwd_ref``, element by element to
the bound of its roundings (``ref.py::bf16_bwd_bound``), at
smollm-135m's training shape (head_dim 64, G = 3, S 2048) and
olmoe-1b-7b's (head_dim 128, G = 1, S 4096) at a small batch, with a
window, a full mask and ragged S; two calls give the same bits; the
forward with the log-sum-exp gives the serving forward's output bits and
the plain version's lse; and one training step of smollm-135m (full
width, 2 layers) launches the backward and leaves
the ``attention_sdpa_train`` counter at 0.  This file imports neither
JAX nor the reference:

    python -m pytest -q tests/test_torch_flash_bwd_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                      attention_ref_lse,
                                                      bf16_bwd_bound)

CASES = {
    # b, s, h, kv, d, causal, window
    "smollm-135m": (2, 2048, 9, 3, 64, True, None),
    "olmoe-1b-7b": (1, 4096, 16, 16, 128, True, None),
    "window": (2, 333, 6, 2, 64, True, 100),
    "full": (2, 512, 4, 2, 128, False, None),
    "ragged": (3, 77, 9, 3, 32, True, None),
    "ragged-window": (2, 130, 4, 1, 128, True, 65),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _inputs(dev, b, s, h, kv, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, n, d), generator=g, device=dev)
            .to(torch.bfloat16) for n in (h, kv, kv, h)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bwd_matches_its_formulas_on_card(case):
    dev = _cuda()
    b, s, h, kv, d, causal, window = CASES[case]
    q, k, v, dout = _inputs(dev, b, s, h, kv, d, s + h + d)
    FK.reset_launches()
    out, lse = FK.flash_attention(q, k, v, causal=causal, window=window,
                                  lse=True)
    dq, dk, dv = FK.flash_attention_bwd(q, k, v, out, dout, lse,
                                        causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {"flash_attention": 0, "flash_attention_lse": 1,
                           "flash_attention_bwd": 1,
                           "attention_sdpa_train": 0}
    # the forward's lse is the plain version's, up to f32 sums in another
    # order (scores from exact bf16 products on both sides)
    _, lse_ref = attention_ref_lse(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    assert float((lse - lse_ref).abs().max()) < 5e-5
    ref = attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                            window=window)
    bounds = bf16_bwd_bound(q, k, v, out, dout, lse, ref, causal=causal,
                            window=window)
    for name, got, want, bound in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                      bounds):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.float() - want).abs()
        assert bool(torch.isfinite(got.float()).all()), name
        over = err > bound
        assert not bool(over.any()), (
            name, int(over.sum()), float(err[over].max()),
            float(bound[over].min()), float(err.max() / want.abs().max()))


@pytest.mark.gpu
def test_flash_bwd_is_deterministic_on_card():
    """Two calls on the same inputs give the same bits (no atomics): the
    card's bit-for-bit training tests compare runs."""
    dev = _cuda()
    b, s, h, kv, d, causal, window = CASES["smollm-135m"]
    q, k, v, dout = _inputs(dev, b, s, h, kv, d, 7)
    out, lse = FK.flash_attention(q, k, v, causal=causal, lse=True)
    first = FK.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    again = FK.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    out2, lse2 = FK.flash_attention(q, k, v, causal=causal, lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["smollm-135m", "window", "full"])
def test_lse_leaves_the_serving_forward_bits_on_card(case):
    dev = _cuda()
    b, s, h, kv, d, causal, window = CASES[case]
    q, k, v, _ = _inputs(dev, b, s, h, kv, d, 11)
    serving = FK.flash_attention(q, k, v, causal=causal, window=window)
    out, _ = FK.flash_attention(q, k, v, causal=causal, window=window,
                                lse=True)
    assert torch.equal(serving, out)


@pytest.mark.gpu
def test_attention_differentiates_through_the_kernels_on_card():
    """``ops.attention`` on inputs that need a gradient: the forward with
    the log-sum-exp, and autograd's backward is the backward kernel."""
    dev = _cuda()
    b, s, h, kv, d, causal, window = CASES["window"]
    q, k, v, dout = _inputs(dev, b, s, h, kv, d, 5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    FK.reset_launches()
    out = fops.attention(*leaves, causal=causal, window=window)
    out.backward(dout)
    assert FK.LAUNCHES == {"flash_attention": 0, "flash_attention_lse": 1,
                           "flash_attention_bwd": 1,
                           "attention_sdpa_train": 0}
    o2, lse = FK.flash_attention(q, k, v, causal=causal, window=window,
                                 lse=True)
    assert torch.equal(out.detach(), o2)
    want = FK.flash_attention_bwd(q, k, v, o2, dout, lse, causal=causal,
                                  window=window)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    # f32 and head dims without a backward instance stay forward only
    with pytest.raises(RuntimeError, match="forward only"):
        fops.attention(leaves[0].float(), k.float(), v.float())


@pytest.mark.gpu
def test_training_step_takes_the_kernels_on_card():
    """One step of smollm-135m at full width (2 of 30 layers, remat on,
    bf16) through the training entry point, 4 stacked vertices: every
    attention call takes the kernels, none the blockwise sdpa."""
    _cuda()
    from repro_torch import configs
    from repro_torch.launch import train
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    assert cfg.remat and cfg.act_dtype == torch.bfloat16
    FK.reset_launches()
    res = train.main(["--arch", "smollm-135m", "--batch", "8", "--seq",
                      "256", "--mesh", "2,2,1", "--sync", "edst", "--steps",
                      "1", "--log-every", "1", "--device", "cuda"], cfg=cfg)
    torch.cuda.synchronize()
    assert all(torch.isfinite(torch.tensor(x)) for x in res.losses)
    calls = cfg.n_layers * 4            # layers x vertices, one step
    assert FK.LAUNCHES["attention_sdpa_train"] == 0
    # the forward runs again under remat's recompute
    assert FK.LAUNCHES["flash_attention_bwd"] == calls, FK.LAUNCHES
    assert FK.LAUNCHES["flash_attention_lse"] == 2 * calls, FK.LAUNCHES
