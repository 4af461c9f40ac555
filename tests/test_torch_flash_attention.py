"""The port's flash attention against the reference.

The port's CPU path (its plain PyTorch version, ``ref.py``) is held
against the reference's Pallas kernel, called directly in interpret mode
(its ``ops`` dispatch to jnp off the TPU), and against its oracle
``attention_ref``, on the same numpy inputs: the five shape cases of the
reference's kernel test in f32 and bf16, to its 2e-5 (f32) and 2e-2
(bf16), and recurrentgemma's MQA layout (10 query heads over one key
head, head_dim 256) with a window.  The CUDA kernel is held against the
plain version on the card in ``test_torch_kernels_gpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import attention_ref

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

FLASH_CASES = [
    # b, s, h, kv, d, qb, kb, causal, window (the reference's test cases)
    (2, 128, 8, 2, 64, 32, 64, True, None),
    (1, 100, 4, 4, 32, 32, 32, True, None),
    (2, 256, 8, 1, 128, 64, 128, True, 48),
    (1, 128, 2, 2, 64, 128, 128, False, None),
    (1, 64, 4, 2, 128, 16, 16, True, None),
    # recurrentgemma-2b's layout: MQA, group 10, head_dim 256, a window
    (1, 96, 10, 1, 256, 32, 32, True, 40),
]


def _qkv(b, s, h, kv, d, dtype, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, n, d).astype(np.float32) for n in (h, kv, kv)]
    return ([jnp.asarray(x).astype(_JDT[dtype]) for x in arrays],
            [torch.from_numpy(x).to(_TDT[dtype]) for x in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("b,s,h,kv,d,qb,kb,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference(b, s, h, kv, d, qb, kb, causal, window,
                                     dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, h, kv, d, dtype, s + h + d)
    out = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == _TDT[dtype] and out.shape == (b, s, h, d)
    for ref in (j_flash(jq, jk, jv, causal=causal, window=window, q_block=qb,
                        kv_block=kb, interpret=True),
                j_ref(jq, jk, jv, causal=causal, window=window)):
        assert np.max(np.abs(_np(out) - _np(ref))) < _TOL[dtype]


def test_unaligned_full_attention_raises_like_the_reference():
    """causal=False needs T aligned to the reference's default key block
    (min(512, T)); T = 600 is not."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 600, 2, 1, 32, "float32", 0)
    with pytest.raises(ValueError, match="block-aligned"):
        j_flash(jq, jk, jv, causal=False, interpret=True)
    with pytest.raises(ValueError, match="block-aligned"):
        tops.attention(tq, tk, tv, causal=False)
    # causal attention at the same T is fine on both sides
    out = tops.attention(tq[:, :40], tk[:, :40], tv[:, :40], window=16)
    ref = j_ref(jq[:, :40], jk[:, :40], jv[:, :40], window=16)
    assert np.max(np.abs(_np(out) - _np(ref))) < 2e-5


def test_window_and_causality_mask_the_right_keys():
    """One-hot values read back which keys each query saw."""
    s, w = 12, 4
    q = torch.zeros((1, s, 1, 32))
    k = torch.zeros((1, s, 1, 32))
    v = torch.eye(s, 32)[None, :, None, :]
    out = attention_ref(q, k, v, causal=True, window=w)[0, :, 0, :s]
    for t in range(s):
        seen = torch.nonzero(out[t]).flatten().tolist()
        assert seen == list(range(max(0, t - w + 1), t + 1))


def test_cpu_dispatch_takes_the_plain_version_and_builds_nothing():
    _, (tq, tk, tv) = _qkv(2, 33, 4, 2, 64, "float32", 1)
    K.reset_launches()
    out = tops.attention(tq, tk, tv, window=8)
    assert torch.equal(out, attention_ref(tq, tk, tv, window=8))
    assert K.LAUNCHES["flash_attention"] == 0 and K.LIB._lib is None


def test_other_devices_raise():
    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no flash attention kernel"):
        tops.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.flash_attention(*(torch.zeros((1, 4, 2, 32)),) * 3)
