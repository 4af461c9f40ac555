"""The CUDA kernels (tree-combine and the int8 wire codec, flash attention
in f32 and in bf16 on the tensor cores, the RG-LRU scan, WKV6) against
their plain PyTorch versions, on the card (marked ``gpu``; they skip
without a CUDA device).  This file imports
neither JAX nor the reference, so it runs on a machine that has only
PyTorch:

    python -m pytest -q tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                      bf16_kernel_bound)
from repro_torch.kernels.rglru import kernel as RK
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.kernels.tree_combine import kernel as K
from repro_torch.kernels.tree_combine import ref as tref
from repro_torch.kernels.wkv6 import kernel as WK
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.kernels.wkv6.ref import wkv6_ref


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
    assert float((out.float() - ref).abs().max()) <= _combine_tol(ref, dtype)


def _combine_tol(ref, dtype):
    """f32: children may be summed in another order; bf16/f16: one
    rounding of the f32 sum, at most one ulp of the largest value."""
    scale = max(1.0, float(ref.abs().max()))
    return scale * (1e-6 if dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 3, 4097, (1 << 20) + 5])
@pytest.mark.parametrize("nch", [1, 2, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_tree_combine_at_storage_offsets_on_card(l, nch, dtype):
    """recv and partial as contiguous views that start at every element
    offset within 16 bytes (1-3 for f32, 1-7 for bf16 and f16), alone and
    together, at lengths that leave a scalar tail: the kernel's vector
    body runs only where recv's rows, partial and out share 16-byte
    alignment, and a scalar head and tail take the rest."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(l + nch)
    lanes = 16 // torch.empty((), dtype=dtype).element_size()
    rbuf = torch.randn((nch * l + lanes,), generator=g, device=dev).to(dtype)
    pbuf = torch.randn((l + lanes,), generator=g, device=dev).to(dtype)
    for ro, po in [(o, o) for o in range(lanes)] + [(0, o) for o in range(
            1, lanes)] + [(o, 0) for o in range(1, lanes)]:
        recv = rbuf[ro:ro + nch * l].view(nch, l)
        part = pbuf[po:po + l]
        out = K.tree_combine(recv, part)
        ref = tref.tree_combine_ref(recv, part).float()
        err = float((out.float() - ref).abs().max())
        assert out.dtype == dtype and out.shape == (l,)
        assert err <= _combine_tol(ref, dtype), (ro, po, err)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 4097, (1 << 20) + 5, 1 << 24])
@pytest.mark.parametrize("offset", [0, 1])
def test_tree_combine_one_child_f32_is_torch_add_on_card(l, offset):
    """One child in f32, the training path's call: partial + recv[0] with
    one rounding, bit for bit the plain version and ``torch.add``."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(l)
    recv = torch.randn((l + 1,), generator=g, device=dev)[offset:][:l]
    part = torch.randn((l + 1,), generator=g, device=dev)[offset:][:l]
    out = K.tree_combine(recv.view(1, l), part)
    assert torch.equal(out, tref.tree_combine_ref(recv.view(1, l), part))
    assert torch.equal(out, torch.add(part, recv))


def _pack_input(dev, g, rows, m, offset, edges):
    """(rows, m) f32 as a contiguous view at ``offset`` floats into its
    buffer; with ``edges``, the second-to-last row all zeros (scale 1e-30,
    every lane 0) and the last one large value among N(0, 1) lanes (most
    of its lanes round to 0)."""
    buf = torch.randn((rows * m + offset,), generator=g, device=dev) * 3.3
    x = buf[offset:].view(rows, m)
    if edges and rows >= 2:
        x[-2] = 0.0
        x[-1, m // 2] = 1e6
    return x


# the path's layout and ragged rows; m = 1, 3, 4, 15, 16, 17 around one
# 16-byte vector; m = 1, 2, 3 mod 4 at two block widths and more, over 5
# rows, so both x's rows and the wire rows (m + 4 bytes each) start at
# every 16-byte phase
@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", [(16, 1 << 20), (3, 257), (1, 5),
                                    (32, 4099), (5, 1), (5, 3), (5, 4),
                                    (5, 15), (5, 16), (5, 17), (5, 2049),
                                    (5, 2050), (6, 2051), (4, 2052)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("edges", [False, True])
def test_q8_kernels_on_card(rows, m, offset, edges):
    """The pack byte-identical to the plain version (its 16-byte body, the
    scalar head and tail each row finds from its own address, 4-byte or
    byte stores), the combine and unpack within 1e-6."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    x = _pack_input(dev, g, rows, m, offset, edges)
    w = K.q8_pack_rows(x)
    assert torch.equal(w, tref.q8_pack_rows_ref(x))
    part = torch.randn((rows, m), generator=g, device=dev)
    assert float((K.q8_combine_rows(w, part)
                  - tref.q8_combine_rows_ref(w, part)).abs().max()) <= 1e-6
    assert float((K.q8_unpack_rows(w)
                  - tref.q8_unpack_rows_ref(w)).abs().max()) <= 1e-6
    assert bool((K.q8_unpack_rows(torch.zeros_like(w)) == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 128, 8, 2, 64, True, None),       # GQA
    (1, 100, 4, 4, 32, True, None),       # ragged S, MHA
    (2, 256, 8, 1, 128, True, 48),        # MQA, window
    (1, 128, 2, 2, 64, False, None),      # full attention
    (1, 77, 10, 1, 256, True, 40),        # recurrentgemma's layout, ragged
    (1, 230, 10, 1, 256, True, 70),       # ... window over several tiles
    (2, 300, 9, 3, 64, True, None),       # smollm's layout, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_card(b, s, h, kv, d, causal, window,
                                        dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(s + h)
    q = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, kv, d), generator=g, device=dev).to(dtype)
    FK.reset_launches()
    out = fops.attention(q, k, v, causal=causal, window=window)
    assert FK.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype
    _assert_flash_close(out, q, k, v, causal, window)


def _assert_flash_close(out, q, k, v, causal, window):
    """The reference's kernel-test tolerances (f32: sums in another order,
    2e-5; bf16: 2e-2), and in bf16 also the per-element bound of the
    tensor-core kernel's roundings, which a fault in the many-key rows
    (whose outputs are far under 2e-2) would break."""
    ref = attention_ref(q, k, v, causal=causal, window=window)
    err = (out.float() - ref.float()).abs()
    assert float(err.max()) < (2e-5 if q.dtype == torch.float32 else 2e-2)
    if q.dtype == torch.bfloat16:
        bound = bf16_kernel_bound(q, k, v, ref, causal=causal, window=window)
        assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("s,t,h,kv,window", [
    (40, 40, 10, 1, None),        # T < 64: one ragged key tile
    (63, 63, 9, 3, 1),            # S = 64 - 1, window of one key
    (65, 65, 10, 1, 63),          # S = 64 + 1
    (127, 127, 9, 3, 64),         # S = 128 - 1, window of one tile
    (129, 129, 10, 1, 65),        # S = 128 + 1, window past a tile edge
    (193, 193, 9, 3, None),       # S = 192 + 1, causal only
    (100, 150, 10, 1, 70),        # T > S
    (150, 100, 9, 3, None),       # T < S
])
@pytest.mark.parametrize("d", FK.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_ragged_edges_on_card(s, t, h, kv, window, d, dtype):
    """Ragged S and T around 64-key tiles and 128-row blocks, windows of
    1, 63, 64 and 65, G = 10 and G = 3, every head_dim: bf16 on the
    tensor-core kernel within 2e-2 and the per-element bound, f32 on the
    CUDA-core kernel within 2e-5, one launch each."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(s + t + d)
    q = torch.randn((2, s, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((2, t, kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((2, t, kv, d), generator=g, device=dev).to(dtype)
    FK.reset_launches()
    out = fops.attention(q, k, v, window=window)
    assert FK.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    _assert_flash_close(out, q, k, v, True, window)


@pytest.mark.gpu
def test_flash_attention_refuses_unaligned_inputs_on_card():
    """The kernels load 16 bytes at once: a contiguous view that starts
    off a 16-byte boundary is refused, not read misaligned."""
    dev = _cuda()
    buf = torch.zeros((1 + 40 * 4 * 64,), device=dev)
    q = buf[1:].view(1, 40, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fops.attention(q, q, q)


@pytest.mark.gpu
def test_flash_attention_refuses_gradients_on_card():
    dev = _cuda()
    q = torch.randn((1, 8, 2, 32), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        fops.attention(q, q.detach(), q.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w", [(2, 100, 48), (1, 64, 128), (3, 17, 8),
                                   (8, 333, 2560)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_scan_kernel_on_card(b, t, w, with_h0):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(t + w)
    a = torch.sigmoid(torch.randn((b, t, w), generator=g, device=dev))
    bx = torch.randn((b, t, w), generator=g, device=dev)
    h0 = torch.randn((b, w), generator=g, device=dev) if with_h0 else None
    h, h_last = RK.rglru_scan(a, bx, h0)
    rh, rl = rglru_ref(a, bx, h0)
    # the kernel rounds the multiply and the add as the plain loop does
    assert torch.equal(h, rh) and torch.equal(h_last, rl)


def _wkv_inputs(dev, b, t, h, n, dtype, decay=(0.5, -4.0), seed=0):
    """r, k, v ~ N(0, 1) in ``dtype``; logw = -exp(a x + c) f32; u, s0."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v = (randn(b, t, h, n).to(dtype) for _ in range(3))
    logw = -torch.exp(decay[0] * randn(b, t, h, n) + decay[1])
    return r, k, v, logw, 0.5 * randn(h, n), randn(b, h, n, n)


def wkv_tol(out, ref, dtype):
    """f32: sums in another order, 2e-4 of the largest output (the
    reference kernel test's 2e-4, scaled); bf16: one bf16 rounding of each
    output on top of that."""
    atol = 2e-4 * max(1.0, float(ref.float().abs().max()))
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,n,c", [
    (2, 100, 3, 16, 32),      # the reference test's shapes
    (1, 64, 2, 64, 64),
    (2, 33, 4, 8, 16),
    (3, 130, 5, 64, 64),      # ragged last chunk at the model's N
    (2, 20, 3, 32, 64),       # T < chunk
    (1, 257, 2, 48, 64),      # N not a power of two
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_kernel_on_card(b, t, h, n, c, dtype, with_s0):
    dev = _cuda()
    r, k, v, logw, u, s0 = _wkv_inputs(dev, b, t, h, n, dtype, seed=t + n)
    s0 = s0 if with_s0 else None
    WK.reset_launches()
    out, s = wops.wkv(r, k, v, logw, u, s0, chunk=c)
    assert WK.LAUNCHES["wkv6"] == 1
    ro, rs = wkv6_ref(r, k, v, logw, u, s0, chunk=c)
    assert out.dtype == dtype and s.dtype == torch.float32
    assert wkv_tol(out, ro, dtype)
    assert wkv_tol(s, rs, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [(0.3, -6.0), (0.5, 1.5)],
                         ids=["model", "clamp"])
def test_wkv6_kernel_at_model_and_strong_decays_on_card(decay):
    """The model's decays and a strong decay whose cumulative log-decay
    over a chunk passes 85, so the clamp acts: finite, and within the f32
    tolerance of the plain version (both keep subnormals)."""
    dev = _cuda()
    r, k, v, logw, u, _ = _wkv_inputs(dev, 2, 200, 3, 64, torch.float32,
                                      decay, seed=9)
    assert (float(-logw[:, :64].cumsum(1).min()) > 85.0) == (decay[1] > 0)
    out, s = WK.wkv6(r, k, v, logw, u)
    ro, rs = wkv6_ref(r, k, v, logw, u)
    assert bool(torch.isfinite(out).all() and torch.isfinite(s).all())
    assert wkv_tol(out, ro, torch.float32) and wkv_tol(s, rs, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [80, 96, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_at_16_row_boundaries_on_card(t, dtype):
    """A last chunk that ends on a 16-row strip boundary inside the
    64-row tile (80, 96) and one of a single row (4097)."""
    dev = _cuda()
    r, k, v, logw, u, s0 = _wkv_inputs(dev, 2, t, 2, 64, dtype, seed=t)
    out, s = WK.wkv6(r, k, v, logw, u, s0)
    ro, rs = wkv6_ref(r, k, v, logw, u, s0)
    assert wkv_tol(out, ro, dtype) and wkv_tol(s, rs, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_at_the_path_heads_below_the_sm_count_on_card(dtype):
    """rwkv6-7b's heads (64 of 64) at batch 1: 64 blocks, fewer than the
    SMs, over 8 chunks, at the model's decays."""
    dev = _cuda()
    r, k, v, logw, u, _ = _wkv_inputs(dev, 1, 512, 64, 64, dtype,
                                      (0.3, -6.0), seed=5)
    out, s = WK.wkv6(r, k, v, logw, u)
    ro, rs = wkv6_ref(r, k, v, logw, u)
    assert wkv_tol(out, ro, dtype) and wkv_tol(s, rs, torch.float32)


@pytest.mark.gpu
def test_wkv6_large_inputs_in_the_clamp_regime_on_card():
    """r scaled by 100 and k by 4 where the clamp acts: the score factors
    reach |k| e^{85} (finite: past |k| = 41 that factor overflows f32 in
    the plain version too, whose output is then NaN, so k is not scaled
    further) and the diagonal score tiles are masked by a select.  Output
    and state are finite and within the f32 tolerance."""
    dev = _cuda()
    r, k, v, logw, u, _ = _wkv_inputs(dev, 2, 200, 3, 64, torch.float32,
                                      (0.5, 1.5), seed=11)
    r, k = 100.0 * r, 4.0 * k
    assert float(-logw[:, :64].cumsum(1).min()) > 85.0
    out, s = WK.wkv6(r, k, v, logw, u)
    ro, rs = wkv6_ref(r, k, v, logw, u)
    assert bool(torch.isfinite(ro).all() and torch.isfinite(rs).all())
    assert bool(torch.isfinite(out).all() and torch.isfinite(s).all())
    assert wkv_tol(out, ro, torch.float32) and wkv_tol(s, rs, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype,offset", [
    (20, torch.bfloat16, 0),  # rows of 40 bytes: no 16-byte copies
    (6, torch.float32, 0),    # rows of 24 bytes
    (64, torch.bfloat16, 1),  # r, k, v, logw one element off 16 bytes
])
def test_wkv6_scalar_loads_on_card(n, dtype, offset):
    """Where N or a pointer forbids 16-byte copies the kernel fills its
    stages by scalar loads; the result is the same function."""
    dev = _cuda()
    r, k, v, logw, u, s0 = _wkv_inputs(dev, 2, 150, 3, n, dtype, seed=n)

    def shifted(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        y = buf[offset:].view(x.shape)
        y.copy_(x)
        return y

    r, k, v, logw = map(shifted, (r, k, v, logw))
    out, s = WK.wkv6(r, k, v, logw, u, s0)
    ro, rs = wkv6_ref(r, k, v, logw, u, s0)
    assert wkv_tol(out, ro, dtype) and wkv_tol(s, rs, torch.float32)


@pytest.mark.gpu
def test_wkv6_refuses_what_it_does_not_take_on_card():
    dev = _cuda()
    r, k, v, logw, u, _ = _wkv_inputs(dev, 1, 8, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        WK.wkv6(r.cpu(), k, v, logw, u)
    with pytest.raises(ValueError, match="contiguous"):
        WK.wkv6(r.transpose(1, 2), k, v, logw, u)
    big = torch.zeros((1, 8, 1, 128), device=dev)
    with pytest.raises(ValueError, match="head size"):
        WK.wkv6(big, big, big, big, torch.zeros((1, 128), device=dev))
    with pytest.raises(ValueError, match="float32"):
        WK.wkv6(r, k, v, logw.bfloat16(), u)
    with pytest.raises(RuntimeError, match="forward only"):
        wops.wkv(r.requires_grad_(), k, v, logw, u)
