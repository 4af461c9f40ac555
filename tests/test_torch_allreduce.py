"""The port's stacked EDST engine against the reference's
``pipelined_tree_allreduce`` run under ``shard_map`` on 16 fake host
devices (a subprocess), on the same numpy payloads: torus 4x4 (k=2) and
ring 16 (k=1), payload lengths that are and are not multiples of k, f32 to
1e-5 and the compressed wires (``codec`` forced on both sides: ``"full"``
int8 on every hop, ``"bcast"`` int8 broadcast only, ``"hybrid"`` bf16
reduce hops) to 1e-6."""
import numpy as np
import pytest
import torch

from repro_torch.core import topologies as topo
from repro_torch.core.collectives import (allreduce_schedule,
                                          pipelined_spec_from_schedule)
from repro_torch.core.edst_star import star_edsts
from repro_torch.dist.fabric import StackedFabric
from repro_torch.dist.tree_allreduce import (pipelined_tree_allreduce,
                                             resolve_codec, resolve_segments)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors run fastest on one thread (and leave the cores to
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FABRICS = {"torus4x4": (4, 4), "ring16": (16,)}
LENGTHS = (1001, 64)
CODECS = ("off", "full", "bcast", "hybrid")

CODE = r"""
import numpy as np
import jax
from jax.sharding import AxisType, PartitionSpec as P
from repro.core import topologies as topo
from repro.core.edst_star import star_edsts
from repro.core.collectives import (allreduce_schedule,
                                    pipelined_spec_from_schedule)
from repro.dist.tree_allreduce import pipelined_tree_allreduce

mesh = jax.make_mesh((4, 4), ('a', 'b'), axis_types=(AxisType.Auto,) * 2)
out = {}
for name, dims in FABRICS.items():
    sp = topo.device_topology(dims)
    spec = pipelined_spec_from_schedule(
        allreduce_schedule(sp.n, star_edsts(sp).trees), ('a', 'b'))
    for d in LENGTHS:
        x = np.random.RandomState(d).randn(16, d).astype(np.float32)
        for codec in CODECS:
            def body(xs, codec=codec):
                v = xs.reshape(xs.shape[1:])
                return pipelined_tree_allreduce(
                    v, spec, quantize=codec != "off", segments=1,
                    codec=codec)[None]
            f = jax.jit(jax.shard_map(body, mesh=mesh,
                                      in_specs=P(('a', 'b')),
                                      out_specs=P(('a', 'b'))))
            out[f"{name}-{d}-{codec}"] = np.asarray(f(x))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("allreduce") / "ref.npz"
    code = (f"FABRICS = {FABRICS!r}\nLENGTHS = {LENGTHS!r}\n"
            f"CODECS = {CODECS!r}\n"
            f"OUT = {str(path)!r}\n" + CODE)
    subproc(code, 16)
    return dict(np.load(path))


def _spec(dims):
    sp = topo.device_topology(dims)
    return pipelined_spec_from_schedule(
        allreduce_schedule(sp.n, star_edsts(sp).trees), ("a", "b"))


@pytest.mark.parametrize("name", sorted(FABRICS))
@pytest.mark.parametrize("d", LENGTHS)
@pytest.mark.parametrize("codec", CODECS)
def test_stacked_engine_matches_reference(reference, name, d, codec):
    spec = _spec(FABRICS[name])
    x = np.random.RandomState(d).randn(16, d).astype(np.float32)
    y = pipelined_tree_allreduce(torch.from_numpy(x), spec,
                                 StackedFabric(16, "cpu"),
                                 quantize=codec != "off", codec=codec)
    ref = reference[f"{name}-{d}-{codec}"]
    tol = 1e-5 if codec == "off" else 1e-6
    assert y.shape == (16, d)
    assert np.max(np.abs(y.numpy() - ref)) <= tol, (name, d, codec)
    # every vertex holds the same total, close to the plain sum
    assert bool((y == y[0]).all())
    bound = 1e-4 if codec == "off" else 0.35
    assert np.max(np.abs(y[0].numpy() - x.sum(0))
                  / (np.abs(x.sum(0)) + 1)) < bound


@pytest.mark.parametrize("fractions", [(0.7, 0.3), (1.0, 0.0)])
def test_weighted_stripes_sum_exactly(fractions):
    """Weighted chunk rows (``chunk_sizes``), including a retired tree."""
    x = torch.from_numpy(np.random.RandomState(7).randn(16, 53)
                         .astype(np.float32))
    y = pipelined_tree_allreduce(x, _spec((4, 4)), StackedFabric(16, "cpu"),
                                 fractions=fractions)
    assert float((y - x.sum(0)).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        pipelined_tree_allreduce(x, _spec((4, 4)), StackedFabric(16, "cpu"),
                                 fractions=(1.0,))


def test_ppermute_zero_fills_non_receivers():
    fab = StackedFabric(4, "cpu")
    x = torch.arange(1, 13, dtype=torch.float32).reshape(4, 3)
    y = fab.ppermute(x, ((0, 2), (3, 1)))
    assert torch.equal(y[2], x[0]) and torch.equal(y[1], x[3])
    assert bool((y[0] == 0).all()) and bool((y[3] == 0).all())
    assert torch.equal(fab.axis_index(), torch.arange(4))
    assert fab.column([True, False, True, False], 3).shape == (4, 1, 1)


def test_engine_policies():
    assert resolve_codec("auto", "cpu") == "off"
    assert resolve_codec(None, torch.device("cuda", 0)) == "full"
    with pytest.raises(ValueError):
        resolve_codec("zstd", "cpu")
    with pytest.raises(TypeError):      # the device is required
        resolve_codec(None)
    spec = _spec((4, 4))
    assert resolve_segments("auto", spec, 100, "cpu") == 1
    assert resolve_segments(1, spec, 100, "cpu") == 1
    # S>1 is the pipelined scan (tests/test_torch_engines.py)
    assert resolve_segments(4, spec, 100, "cpu") == 4
    # integer payloads travel verbatim even when quantization is asked for
    x = torch.arange(16 * 7, dtype=torch.int64).reshape(16, 7)
    y = pipelined_tree_allreduce(x, spec, StackedFabric(16, "cpu"),
                                 quantize=True, codec="full")
    assert torch.equal(y, x.sum(0).expand(16, 7))
