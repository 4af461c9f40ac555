"""The port's tree-combine and int8 wire codec against the reference.

The port's CPU path (its plain PyTorch versions) is held against the
reference's Pallas kernels, run in interpret mode through
``ops.*(use_pallas=True)``, and against its ``ref.py`` oracles, on the
same numpy inputs: combine to 1e-5 (f32) and 5e-2 (bf16), pack
byte-identical, combine/unpack of a wire to 1e-6.  The CUDA kernels are
held against the plain versions on the card in ``test_torch_kernels_gpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_combine import ops as jops
from repro.kernels.tree_combine import ref as jref
from repro_torch.kernels.tree_combine import kernel as K
from repro_torch.kernels.tree_combine import ops as tops
from repro_torch.kernels.tree_combine import ref as tref

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(shape, dtype, seed, mult=1.0):
    """The same numbers as a JAX array and a CPU tensor of ``dtype``."""
    x = (np.random.RandomState(seed).randn(*shape) * mult).astype(np.float32)
    return (jnp.asarray(x).astype(_JDT[dtype]),
            torch.from_numpy(x).to(_TDT[dtype]))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("nch,l", [(3, 1000), (1, 64), (5, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_combine_matches_reference(nch, l, dtype):
    jr, tr = _pair((nch, l), dtype, 1)
    jp, tp = _pair((l,), dtype, 2)
    out = tops.combine(tr, tp)
    assert out.dtype == _TDT[dtype] and out.shape == (l,)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for ref in (jops.combine(jr, jp, use_pallas=True),
                jref.tree_combine_ref(jr, jp)):
        assert np.max(np.abs(_np(out) - _np(ref))) < tol


@pytest.mark.parametrize("l", [64, 1000, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_wire_matches_reference(l, dtype):
    jx, tx = _pair((l,), dtype, 1, 3.3)
    wire = tops.q8_pack(tx)
    assert wire.dtype == torch.int8 and wire.shape == (l + 4,)
    jwire = jops.q8_pack(jx, use_pallas=True)
    assert np.array_equal(wire.numpy(), np.asarray(jwire))
    assert np.array_equal(wire.numpy(),
                          np.asarray(jref.q8_pack_ref(jx, jref.q8_scale(jx))))

    jp, tp = _pair((l,), "float32", 2)
    out = tops.q8_combine(wire, tp)
    assert np.max(np.abs(out.numpy()
                         - np.asarray(jops.q8_combine(jwire, jp,
                                                      use_pallas=True)))) < 1e-6
    dec = tops.q8_unpack(wire)
    assert np.max(np.abs(dec.numpy()
                         - np.asarray(jops.q8_unpack(jwire, jnp.float32,
                                                     use_pallas=True)))) < 1e-6
    # the round trip stays within half a quantization step
    scale = float(tref.q8_scale(tx))
    assert float((dec - tx.float()).abs().max()) <= scale * 0.51


@pytest.mark.parametrize("rows,m", [(3, 257), (16, 100), (1, 5), (32, 64)])
def test_q8_row_codec_matches_reference(rows, m):
    jx, tx = _pair((rows, m), "float32", rows + m, 2.1)
    wires = tops.q8_pack_rows(tx)
    assert wires.shape == (rows, m + 4) and wires.dtype == torch.int8
    jw = jops.q8_pack_rows(jx, use_pallas=True)
    assert np.array_equal(wires.numpy(), np.asarray(jw))
    assert np.array_equal(wires.numpy(), np.asarray(jref.q8_pack_rows_ref(jx)))
    # row form == the 1-D form row by row
    for j in range(rows):
        assert torch.equal(wires[j], tops.q8_pack(tx[j]))
    dec = tops.q8_unpack_rows(wires)
    assert np.max(np.abs(dec.numpy() - np.asarray(
        jops.q8_unpack_rows(jw, jnp.float32, use_pallas=True)))) < 1e-6
    jp, tp = _pair((rows, m), "float32", 7)
    out = tops.q8_combine_rows(wires, tp)
    expect = np.stack([np.asarray(jops.q8_combine(jw[j], jp[j],
                                                  use_pallas=True))
                       for j in range(rows)])
    assert np.max(np.abs(out.numpy() - expect)) < 1e-6


def test_zero_wire_decodes_to_exact_zeros():
    _, tx = _pair((100,), "float32", 3)
    w = tops.q8_pack(tx)
    assert float((tops.q8_unpack(w) - tx).abs().max()) < 0.05
    # an all-zero wire (what non-receivers get) decodes to exact zeros
    z = torch.zeros_like(w)
    assert bool((tops.q8_unpack(z) == 0).all())
    assert torch.equal(tops.q8_combine(z, tx), tx)
    zr = torch.zeros((4, 104), dtype=torch.int8)
    assert bool((tops.q8_unpack_rows(zr) == 0).all())


def test_dispatch_rejects_other_devices():
    with pytest.raises(ValueError):
        tops.combine(torch.zeros(1, 4, device="meta"),
                     torch.zeros(4, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    # the wrappers never run a plain version: a CPU tensor is an error
    with pytest.raises(ValueError):
        K.q8_pack_rows(torch.zeros(2, 8))
    with pytest.raises(ValueError):
        K.tree_combine(torch.zeros(1, 8), torch.zeros(8))

