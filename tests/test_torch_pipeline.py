"""The port's GPipe schedule (``repro_torch.dist.pipeline``) against the
reference's.

``bubble_fraction`` equals the reference's over a grid.
``pipeline_apply`` on the stacked fabric is held to the reference's
``pipeline_apply`` under ``shard_map`` (one subprocess with 4 host
devices, a mesh of ``AxisType.Auto`` axes) and to the stages applied in
order, at the reference test's sizes (4 stages, 8 microbatches of 2,
d 16) on numpy inputs from a seed, within atol 1e-5 as
``tests/test_pipeline.py`` holds it; on 4 gloo ranks (one stage a rank)
it equals the stacked result bit for bit.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
from repro_torch.dist.pipeline import bubble_fraction, pipeline_apply
from test_torch_fabric_pg import one_thread, spawn_ranks

N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16

REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.dist.pipeline import pipeline_apply

data = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ('stage',), axis_types=(AxisType.Auto,))

def stage_fn(w, h):
    return jnp.tanh(h @ w[0])

def pipelined(ws, x):
    return pipeline_apply(stage_fn, ws, x, 'stage')

y = jax.jit(jax.shard_map(pipelined, mesh=mesh,
                          in_specs=(P('stage'), P()),
                          out_specs=P(), check_vma=False))(
    jnp.asarray(data['ws']), jnp.asarray(data['x']))
np.save(sys.argv[2], np.asarray(y))
"""


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return ws, x


def stage_fn(w, h):
    """``tanh(h @ w)`` for each local stage, one matmul a stage, so every
    fabric runs the same ops on the same shapes."""
    return torch.stack([torch.tanh(h[i] @ w[i]) for i in range(h.shape[0])])


def _sequential(ws, x):
    for s in range(N_STAGES):
        x = np.tanh(x @ ws[s])
    return x


def test_bubble_fraction_equals_the_reference():
    from repro.dist.pipeline import bubble_fraction as ref
    for m in (1, 2, 3, 8, 17, 64):
        for s in (0, 1, 2, 4, 6, 16):
            assert bubble_fraction(m, s) == ref(m, s), (m, s)
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-9


def test_stacked_matches_the_reference_and_the_stages(tmp_path, subproc):
    ws, x = _inputs()
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    code = REFERENCE.replace("sys.argv[1]", repr(str(tmp_path / "in.npz"))) \
        .replace("sys.argv[2]", repr(str(tmp_path / "ref.npy")))
    subproc(code, N_STAGES)
    ref = np.load(tmp_path / "ref.npy")
    y = pipeline_apply(stage_fn, torch.from_numpy(ws), torch.from_numpy(x),
                       StackedFabric(N_STAGES, "cpu")).numpy()
    assert y.shape == (N_MICRO, MB, D)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y, _sequential(ws, x), rtol=0, atol=1e-5)


def test_one_stage_is_the_stage_itself():
    ws, x = _inputs()
    y = pipeline_apply(stage_fn, torch.from_numpy(ws[:1]),
                       torch.from_numpy(x), StackedFabric(1, "cpu"))
    want = torch.stack([stage_fn(torch.from_numpy(ws[:1]), xm[None])[0]
                        for xm in torch.from_numpy(x)])
    assert torch.equal(y, want)


def _pipeline_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        ws, x = _inputs()
        fabric = ProcessGroupFabric(N_STAGES, "cpu")
        y = pipeline_apply(stage_fn,
                           torch.from_numpy(ws)[fabric.lo:fabric.hi],
                           torch.from_numpy(x), fabric)
        torch.save(y, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", (4, 2))
def test_process_group_equals_stacked(tmp_path, world):
    ws, x = _inputs()
    with one_thread():
        want = pipeline_apply(stage_fn, torch.from_numpy(ws),
                              torch.from_numpy(x),
                              StackedFabric(N_STAGES, "cpu"))
    for y in spawn_ranks(tmp_path, _pipeline_rank, world):
        assert torch.equal(y, want)
