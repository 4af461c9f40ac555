"""The EDST engines on the card (marked ``gpu``; they skip without a CUDA
device): the per-tree, fused, pipelined (S = 1 and 4) and striped
allreduces of a stacked 16-vertex payload, on the 4x4 torus (k=2) and the
ring 16 (k=1), at ragged lengths, in f32 and over the int8 wire, against
``payload.sum(0)`` and against the same engine on the CPU (the plain
versions of the kernels).  This file imports neither JAX nor the
reference, so it runs on a machine that has only PyTorch:

    python -m pytest -q tests/test_torch_engines_gpu.py
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import topologies as topo
from repro_torch.core.collectives import (allreduce_schedule,
                                          fused_spec_from_schedule,
                                          pipelined_spec_from_schedule,
                                          striped_spec_from_schedule)
from repro_torch.core.edst_star import star_edsts
from repro_torch.dist import striped as S
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import StackedFabric
from repro_torch.kernels.tree_combine import kernel as K

FABRICS = {"torus4x4": (4, 4), "ring16": (16,)}
LENGTHS = (1, 63, 4097, (1 << 20) + 5)
ENGINES = ("per_tree", "fused", "pipelined", "pipelined_s4", "striped")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _spec(engine, dims):
    sp = topo.device_topology(dims)
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    if engine == "per_tree":
        return T.spec_from_schedule(sched, ("a", "b"))
    if engine == "fused":
        return fused_spec_from_schedule(sched, ("a", "b"))
    if engine == "striped":
        return striped_spec_from_schedule(sched, ("a", "b"))
    return pipelined_spec_from_schedule(sched, ("a", "b"))


def _run(engine, x, dims, quantize, codec="full"):
    """One allreduce of the stacked ``x`` on its device."""
    spec, fab = _spec(engine, dims), StackedFabric(16, x.device)
    if engine == "per_tree":        # the device's codec, as the reference
        return T.per_tree_allreduce(x, spec, fab, quantize)
    if engine == "fused":
        return T.fused_tree_allreduce(x, spec, fab, quantize, codec=codec)
    if engine == "striped":
        return S.striped_allreduce(x, spec, fab, quantize, codec=codec)
    return T.pipelined_tree_allreduce(
        x, spec, fab, quantize, codec=codec,
        segments=4 if engine == "pipelined_s4" else 1)


def _cpu_quantized(engine, x, dims):
    """The engine's int8 ("full") sum of ``x`` on the CPU, through the
    plain versions of the kernels.  The per-tree engine takes the
    device's codec, "off" on the CPU, so there its trees run through
    ``run_tree_program`` at "full", chunked as the engine chunks."""
    if engine != "per_tree":
        return _run(engine, x, dims, True)
    spec, fab = _spec(engine, dims), StackedFabric(16, x.device)
    size = x.shape[1]
    chunks = F.pad(x, (0, -size % spec.k)).view(16, spec.k, -1)
    return torch.cat([T.run_tree_program(chunks[:, j].contiguous(), tree,
                                         fab, True, codec="full")
                      for j, tree in enumerate(spec.trees)], 1)[:, :size]


def _payload(dev, length, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((16, length), generator=g).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("quantize", [False, True])
def test_engine_sums_on_card(name, length, engine, quantize):
    """f32: within 1e-4 of the largest sum (sums in tree order), and bit
    for bit the engine's CPU result (index moves, masks and one-child
    combines round as the plain versions do).  int8 (codec "full"):
    within n * max_i sum_v |x_v[i]| / 254, half a quantization step per
    quantization an element can pass, and within 4 ulps of the value of
    the engine's int8 CPU result (the kernels round as the plain versions
    do, so a wrong scale or rounding in one segment or stripe shows);
    every vertex row identical except the striped allgather's, which
    re-codes every hop."""
    dev = _cuda()
    x = _payload(dev, length, length + 7)
    y = _run(engine, x, FABRICS[name], quantize)
    torch.cuda.synchronize()
    expect = x.sum(0)
    err = float((y - expect).abs().max())
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    if quantize:
        assert err <= 16 * float(x.abs().sum(0).max()) / 254, err
        ref = _cpu_quantized(engine, x.cpu(), FABRICS[name])
        a = ref.abs()
        tol = 4 * (torch.nextafter(a, torch.full_like(a, float("inf"))) - a)
        diff = (y.cpu() - ref).abs()
        assert bool((diff <= tol).all()), float(diff.max())
        if engine != "striped":
            assert bool((y == y[0]).all())
    else:
        assert err <= 1e-4 * max(1.0, float(expect.abs().max())), err
        assert bool((y == y[0]).all())
        assert torch.equal(y.cpu(), _run(engine, x.cpu(), FABRICS[name],
                                         False))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("length", LENGTHS)
def test_segments_equal_one_segment_on_card(name, length):
    dev = _cuda()
    x = _payload(dev, length, length)
    spec, fab = _spec("pipelined", FABRICS[name]), StackedFabric(16, dev)
    one = T.pipelined_tree_allreduce(x, spec, fab, segments=1)
    for s in (2, 4, 7):
        assert torch.equal(T.pipelined_tree_allreduce(x, spec, fab,
                                                      segments=s), one), s


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
def test_quantized_engines_pack_on_card_by_default(engine):
    """``codec=None`` on a CUDA payload resolves to the int8 wire: every
    engine's quantized call launches the pack and the unpack, and its
    reduce hops the tree-combine."""
    dev = _cuda()
    x = _payload(dev, 4097, 1)
    K.reset_launches()
    _run(engine, x, FABRICS["torus4x4"], True, codec=None)
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    K.reset_launches()
    assert launched["q8_pack_rows"] > 0, launched
    assert launched["q8_unpack_rows"] > 0, launched
    assert launched["tree_combine"] > 0, launched


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
def test_engines_refuse_what_the_codec_does_not_take_on_card(engine):
    """The CUDA codec takes f32 only: a bf16 payload over the int8 wire
    raises (no fallback to the plain versions)."""
    dev = _cuda()
    x = _payload(dev, 257, 2).to(torch.bfloat16)
    with pytest.raises(ValueError):
        _run(engine, x, FABRICS["torus4x4"], True)
