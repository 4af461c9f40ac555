"""The Roskind-Tarjan rescale's allreduce on the card (marked ``gpu``; it
skips without a CUDA device): the 4x4 torus's dense fault runtime
rescaled onto the 15 survivors of a lost vertex (k = 2 over all 28
residual edges), entry 0's sum of a stacked (15, m) payload at ragged
lengths, f32 and over the int8 wire (codec "full"), against the same
runtime's sum on the CPU (the plain versions of the kernels) within 4
ulps of the value, and against ``payload.sum(0)``.  This file imports
neither JAX nor the reference, so it runs on a machine that has only
PyTorch:

    python -m pytest -q tests/test_torch_elastic_gpu.py
"""
import pytest
import torch

from repro_torch.core.fault import FailureEvent
from repro_torch.dist.fabric import StackedFabric
from repro_torch.dist.steps import fault_runtime_for_mesh
from repro_torch.kernels.tree_combine import kernel as K
from repro_torch.launch.elastic import rescale_after_node_loss

LENGTHS = (1, 63, 4097, (1 << 20) + 5)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _rescaled(node):
    torus = fault_runtime_for_mesh((4, 4, 1), ("pod", "data", "model"))
    rt, _ = rescale_after_node_loss(torus,
                                    FailureEvent(nodes=frozenset({node})))
    return rt


@pytest.mark.gpu
@pytest.mark.parametrize("node", [0, 12])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("quantize", [False, True])
def test_rescaled_allreduce_on_card(node, length, quantize):
    dev = _cuda()
    rt = _rescaled(node)
    assert (rt.graph.n, rt.k) == (15, 2)
    g = torch.Generator(device="cpu").manual_seed(length + node)
    x = torch.randn((15, length), generator=g)
    allreduce = rt.make_allreduce(quantize=quantize, codec="full")
    K.reset_launches()
    y = allreduce(x.to(dev), 0, StackedFabric(15, dev))
    torch.cuda.synchronize()
    assert K.LAUNCHES["tree_combine"] > 0
    if quantize:
        assert K.LAUNCHES["q8_pack_rows"] > 0
    ref = allreduce(x, 0, StackedFabric(15, "cpu"))
    y = y.cpu()
    a = ref.abs()
    tol = 4 * (torch.nextafter(a, torch.full_like(a, float("inf"))) - a)
    diff = (y - ref).abs()
    assert bool((diff <= tol).all()), float(diff.max())
    assert bool((y == y[0]).all())
    err = float((y - x.sum(0)).abs().max())
    if quantize:
        assert err <= 15 * float(x.abs().sum(0).max()) / 254, err
    else:
        assert err <= 1e-4 * max(1.0, float(x.sum(0).abs().max())), err
