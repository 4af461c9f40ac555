"""``repro_torch.dist.sharding`` and the model API's logical axes against
the reference's ``repro.dist.sharding`` and model inits.

``spec_for``, ``owner_stripe_spec`` and ``tree_shardings`` must give the
reference's ``PartitionSpec`` entries on every case of
``tests/test_dist_sharding.py`` and on a hypothesis sweep of axis tuples,
shapes and duck-typed meshes.  ``placements()`` must give a DTensor whose
local shape is the split the spec names (on a ``fake`` group of 256 ranks
in one subprocess: the group is process-wide), and
``zero1_state_shardings``' ``Shard(0)`` the rows
``fabric.vertex_blocks`` gives each rank wherever the world divides the
vertex count.  ``ModelAPI.param_axes()`` / ``cache_axes()`` must equal
the axes trees the reference's ``init`` / ``init_cache`` return, for all
ten configs at their reduced size.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as shd
from repro_torch.dist.fabric import vertex_blocks
from repro_torch.models import api as tapi

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def fake_mesh(names, shape):
    class _Devices:
        pass

    class _Mesh:
        axis_names = tuple(names)
        devices = _Devices()

    _Mesh.devices.shape = tuple(shape)
    return _Mesh()


def _same(axes, shape, mesh, fsdp=True):
    got = shd.spec_for(axes, shape, mesh, fsdp=fsdp)
    want = jshd.spec_for(axes, shape, mesh, fsdp=fsdp)
    assert isinstance(got, shd.PartitionSpec)
    assert tuple(got) == tuple(want), (axes, shape, got, want)
    return got


M16 = (("data", "model"), (16, 16))
# every spec_for case of tests/test_dist_sharding.py: (axes, shape, mesh,
# fsdp)
CASES = {
    "fsdp-largest": (("embed", "mlp"), (4096, 11008), M16, True),
    "fsdp-largest-transposed": (("mlp", "embed"), (11008, 4096), M16, True),
    "fsdp-indivisible": (("embed", "head_dim"), (100, 128), M16, True),
    "fsdp-skips-layers": (("layers", "embed"), (32, 4096), M16, True),
    "fsdp-off": (("embed", "mlp"), (4096, 11008), M16, False),
    "model-not-doubled": (("mlp",), (4096,), M16, True),
    "scalar": ((), (), M16, True),
    "unnamed-1d": ((None,), (7,), M16, True),
    "unnamed-2d": ((None, None), (64, 64), M16, True),
    "no-model-axis": (("vocab", "embed"), (50304, 4096),
                      (("data",), (8,)), True),
    "no-model-axis-fsdp-off": (("vocab", "embed"), (50304, 4096),
                               (("data",), (8,)), False),
    "no-data-axes-batch": (("batch", None), (8, 128), (("model",), (4,)),
                           True),
    "no-data-axes": (("embed", "mlp"), (4096, 11008), (("model",), (4,)),
                     True),
    "unknown-axis": (("state", "embed"), (8192, 4096), M16, True),
    "batch-pod-data": (("batch", None), (64, 128),
                       (("pod", "data", "model"), (2, 16, 16)), False),
    "batch-indivisible": (("batch", None), (16, 128),
                          (("pod", "data", "model"), (2, 16, 16)), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_for_equals_the_reference(case):
    axes, shape, (names, sizes), fsdp = CASES[case]
    _same(axes, shape, fake_mesh(names, sizes), fsdp)


def test_tree_shardings_structure_and_cache_pairs():
    """The reference test's tree: a (k, v) pair of axis tuples is an
    interior node; every leaf is a ``Sharding`` with the reference's
    spec."""
    mesh = fake_mesh(("data", "model"), (1, 1))

    class _S:
        def __init__(self, *shape):
            self.shape = shape

    params = {"w": _S(64, 128), "scale": _S(64),
              "cache": (_S(2, 8, 4, 16), _S(2, 8, 4, 16))}
    axes = {"w": ("embed", "mlp"), "scale": ("embed",),
            "cache": (("batch", None, "kv_heads", "head_dim"),
                      ("batch", None, "kv_heads", "head_dim"))}
    sh = shd.tree_shardings(axes, params, mesh)
    want = jshd.tree_shardings(
        axes, jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jax.numpy.float32), params,
            is_leaf=lambda x: isinstance(x, _S)),
        jax.make_mesh((1, 1), ("data", "model")))
    assert tuple(sh["w"].spec) == tuple(want["w"].spec) == ("data", "model")
    assert tuple(sh["scale"].spec) == tuple(want["scale"].spec)
    assert isinstance(sh["cache"], tuple) and len(sh["cache"]) == 2
    for got, ref in zip(sh["cache"], want["cache"]):
        assert isinstance(got, shd.Sharding) and got.mesh is mesh
        assert tuple(got.spec) == tuple(ref.spec)


NAMES = (None, "batch", "embed", "embed2", "mlp", "mlp2", "heads",
         "kv_heads", "head_dim", "vocab", "experts", "layers", "state")
MESHES = ((("data", "model"), (16, 16)), (("data", "model"), (4, 2)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 2, 1)), (("data",), (8,)),
          (("model",), (4,)), (("pod", "data"), (2, 4)))
DIMS = (1, 2, 3, 4, 7, 8, 12, 16, 28, 32, 48, 64, 100, 128, 256, 4096)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(NAMES), st.sampled_from(DIMS)),
                max_size=5),
       st.sampled_from(MESHES), st.booleans())
def test_spec_for_sweep_equals_the_reference(dims, mesh, fsdp):
    axes = tuple(a for a, _ in dims)
    shape = tuple(d for _, d in dims)
    m = fake_mesh(*mesh)
    spec = _same(axes, shape, m, fsdp)
    assert tuple(shd.owner_stripe_spec(m)) == \
        tuple(jshd.owner_stripe_spec(m))
    # the local shape divides the global one exactly
    loc = shd.local_shape(spec, shape, m)
    sizes = dict(zip(*mesh))
    for i, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else entry or ()
        split = 1
        for a in names:
            split *= sizes[a]
        assert loc[i] * split == shape[i]


@pytest.mark.parametrize("n,world", [(16, 4), (16, 16), (32, 8), (12, 3),
                                     (10, 4), (10, 3)])
def test_zero1_shardings_against_vertex_blocks(n, world):
    """Where the world divides n, ``Shard(0)`` of the owner-stripe rows
    gives every rank the rows of its vertex block; where it does not,
    DTensor's ceil-sized chunks differ (the docstring's 10-over-4 case)."""
    from torch.distributed.tensor import Shard
    from repro_torch.optim.sharded import ShardedOptState
    mesh = fake_mesh(("data", "model"), (world, 1))
    sh = shd.zero1_state_shardings(ShardedOptState(0, None, None), mesh)
    assert tuple(sh.mu.spec) == ("data",) and tuple(sh.step.spec) == ()
    assert sh.mu.placements == (Shard(0), shd.placements((), mesh)[1])
    chunks = []
    for r in range(world):     # DTensor's own split of n rows
        size, off = Shard(0)._local_shard_size_and_offset(n, world, r)
        chunks.append((off, off + size))
    blocks = vertex_blocks(n, world)
    assert (chunks == blocks) == (n % world == 0), (chunks, blocks)
    if (n, world) == (10, 4):
        assert [b - a for a, b in chunks] == [3, 3, 3, 1]
        assert [b - a for a, b in blocks] == [3, 3, 2, 2]


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_axes_trees_equal_the_reference(arch):
    """``param_axes()`` / ``cache_axes()`` against the axes the reference's
    ``init`` / ``init_cache`` return, and each leaf's length the ndim of
    the port's parameter or cache it names."""
    import torch
    api = japi.build(jconfigs.get(arch).reduced())
    box = {}

    def init(k):
        p, box["p"] = api.init(k)
        return p

    def cache():
        c, box["c"] = api.init_cache(2, 8)
        return c
    jax.eval_shape(init, jax.random.PRNGKey(0))
    jax.eval_shape(cache)

    def norm(t):
        if isinstance(t, dict):
            return {k: norm(v) for k, v in t.items()}
        if shd._is_axes_leaf(t):
            return tuple(t)
        return tuple(norm(x) for x in t)
    tpi = tapi.build(tconfigs.get(arch).reduced())
    assert tpi.param_axes() == norm(box["p"])
    assert norm(tpi.cache_axes(2, 8)) == norm(box["c"])
    params = tpi.init(torch.Generator().manual_seed(0))
    shd.map_axes(lambda a, p: _ndim_ok(a, p), tpi.param_axes(), params)
    shd.map_axes(lambda a, c: _ndim_ok(a, c), tpi.cache_axes(2, 8),
                 tpi.init_cache(2, 8))


def _ndim_ok(axes, t):
    assert len(axes) == t.dim(), (axes, tuple(t.shape))


PLACEMENT_CODE = r"""
import json, sys, torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_mesh
out = []
for shape, names in (((16, 16), ("data", "model")),
                     ((2, 8, 16), ("pod", "data", "model"))):
    mesh = make_mesh(shape, names)
    for axes, tshape in CASES:
        for fsdp in (True, False):
            spec = shd.spec_for(axes, tshape, mesh, fsdp=fsdp)
            t = distribute_tensor(torch.empty(tshape, device="meta"), mesh,
                                  shd.placements(spec, mesh),
                                  src_data_rank=None)
            out.append({"spec": [list(e) if isinstance(e, tuple) else e
                                 for e in spec],
                        "local": list(t.to_local().shape),
                        "want": list(shd.local_shape(spec, tshape, mesh))})
print(json.dumps(out))
"""

PLACEMENT_CASES = [
    (("embed", "mlp"), (4096, 11008)), (("vocab", "embed"), (49152, 576)),
    (("layers", "embed", "heads", "head_dim"), (30, 576, 9, 64)),
    (("batch", None), (256, 4097)),
    (("layers", "batch", None, "kv_heads", "head_dim"), (2, 64, 8, 16, 32)),
    (("experts", "embed", "mlp"), (64, 2048, 1024)), ((), ()),
]


def test_placements_give_the_named_split():
    code = f"CASES = {PLACEMENT_CASES!r}\n" + PLACEMENT_CODE
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rows) == 2 * 2 * len(PLACEMENT_CASES)
    for row in rows:
        assert row["local"] == row["want"], row
    assert sum(any(row["spec"]) for row in rows) > len(rows) // 2
