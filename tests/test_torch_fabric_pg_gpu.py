"""The process-group fabric on the card (marked ``gpu``; it skips without a
CUDA device): a world-1 NCCL group opened in this process (a ``FileStore``
under the test's temporary directory) carries every engine of a stacked
16-vertex payload on the 4x4 torus, f32 and over the int8 wire, and
``pipeline_apply``, and the reduced smollm-135m's train step under
``psum_dp``, ``edst`` and ``gspmd``; each must equal the same call on
``StackedFabric`` (the stacked step) bit for bit.  A CPU tensor on the
NCCL fabric is refused.  This file imports neither JAX nor the reference:

    python -m pytest -q tests/test_torch_fabric_pg_gpu.py
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import topologies as topo
from repro_torch.core.collectives import (allreduce_schedule,
                                          fused_spec_from_schedule,
                                          pipelined_spec_from_schedule,
                                          striped_spec_from_schedule)
from repro_torch.core.edst_star import star_edsts
from repro_torch.data import SyntheticLMStream
from repro_torch.dist import striped as S
from repro_torch.dist import tree_allreduce as T
from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist.steps import make_train_step
from repro_torch.models.api import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

pytestmark = pytest.mark.gpu

ENGINES = ("per_tree", "fused", "pipe_s1", "pipe_s4", "striped")
LENGTH = (1 << 16) + 5


@pytest.fixture
def nccl(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL carries CUDA tensors)")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _run(engine, x, fabric, quantize):
    sp = topo.device_topology((4, 4))
    sched = allreduce_schedule(sp.n, star_edsts(sp).trees)
    codec = "full" if quantize else "off"
    if engine == "per_tree":
        return T.per_tree_allreduce(x, T.spec_from_schedule(sched, ("d",)),
                                    fabric, quantize)
    if engine == "fused":
        return T.fused_tree_allreduce(
            x, fused_spec_from_schedule(sched, ("d",)), fabric, quantize,
            codec=codec)
    if engine == "striped":
        return S.striped_allreduce(
            x, striped_spec_from_schedule(sched, ("d",)), fabric, quantize,
            codec=codec)
    return T.pipelined_tree_allreduce(
        x, pipelined_spec_from_schedule(sched, ("d",)), fabric, quantize,
        codec=codec, segments=int(engine[-1]))


@pytest.mark.parametrize("quantize", (False, True))
@pytest.mark.parametrize("engine", ENGINES)
def test_world1_nccl_equals_stacked(nccl, engine, quantize):
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((16, LENGTH), generator=g).to(nccl)
    want = _run(engine, x, StackedFabric(16, nccl), quantize)
    got = _run(engine, x, ProcessGroupFabric(16, nccl), quantize)
    assert torch.equal(got, want)


def test_pipeline_world1_nccl_equals_stacked(nccl):
    g = torch.Generator(device="cpu").manual_seed(4)
    ws = (torch.randn((6, 64, 64), generator=g) * 0.2).to(nccl)
    x = torch.randn((8, 4, 64), generator=g).to(nccl)

    def stage_fn(w, h):
        return torch.stack([torch.tanh(h[i] @ w[i])
                            for i in range(h.shape[0])])

    want = pipeline_apply(stage_fn, ws, x, StackedFabric(6, nccl))
    got = pipeline_apply(stage_fn, ws, x, ProcessGroupFabric(6, nccl))
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ("psum_dp", "edst", "gspmd"))
def test_world1_nccl_train_step_equals_stacked(nccl, mode):
    cfg = configs.get("smollm-135m").reduced()
    api = build(cfg)
    params = api.init(torch.Generator(device=nccl).manual_seed(0), nccl)
    batch = {"tokens": torch.as_tensor(
        SyntheticLMStream(cfg.vocab, 16, 16, seed=0).batch(0),
        dtype=torch.long, device=nccl)}
    opt = AdamW(cosine_schedule(3e-4, 2, 10))
    outs = []
    # no group: the stacked step (one rank); the world group: the
    # process-group fabric at world size 1
    for group in (None, dist.group.WORLD):
        step = make_train_step(api, opt, (4, 4, 1), ("pod", "data", "model"),
                               mode=mode, group=group)
        new, _, met = step(params, opt.init(params), batch)
        outs.append((torch.cat([p.detach().reshape(-1)
                                for p in tree_leaves(new)]),
                     float(met["loss"]), float(met["grad_norm"])))
    (want, *wm), (got, *gm) = outs
    assert gm == wm
    assert torch.equal(got, want)


def test_nccl_fabric_refuses_cpu_tensors(nccl):
    fabric = ProcessGroupFabric(16, nccl)
    with pytest.raises(ValueError, match="nccl group carries cuda"):
        fabric.ppermute(torch.zeros(16, 4), [(0, 1)])
    with pytest.raises(ValueError, match="nccl group carries cuda"):
        ProcessGroupFabric(16, "cpu")
