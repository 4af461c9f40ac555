"""ZeRO-1 on a world-1 NCCL group on the card (marked ``gpu``; it skips
without a CUDA device): the reduced smollm-135m's zero1 step on the 4x4
torus (f32, and the int8 gradient wire), and the striped fault runtime's
flip with ``reshard_owned`` there and back and a step on the degraded
class, each through a :class:`ProcessGroupFabric` of a group opened in
this process (a ``FileStore`` under the test's temporary directory) and
equal bit for bit to the same calls on the stacked fabric.  This file
imports neither JAX nor the reference:

    python -m pytest -q tests/test_torch_zero1_pg_gpu.py
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.fault import FailureEvent
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.fabric import ProcessGroupFabric
from repro_torch.dist.steps import (edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.models.api import build
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

pytestmark = pytest.mark.gpu

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")


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


def _model(dev):
    cfg = configs.get("smollm-135m").reduced()
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    stream = SyntheticLMStream(cfg.vocab, 16, 16, seed=0)

    def batch(i):
        return {"tokens": torch.as_tensor(stream.batch(i), dtype=torch.long,
                                          device=dev)}
    return api, params, batch


def _flat(p):
    return torch.cat([t.reshape(-1) for t in tree_leaves(p)])


def _steps(dev, group, quantize):
    api, params, batch = _model(dev)
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    step = make_train_step(api, opt, SHAPE, NAMES, zero1=True,
                           engine="striped", quantize=quantize,
                           codec="full" if quantize else None,
                           telemetry=True, group=group)
    fabric = None if group is None else ProcessGroupFabric(16, dev, group)
    st = ShardedAdamW(opt).init_for(
        params, edst_spec_for_mesh(SHAPE, NAMES, engine="striped"), 16,
        fabric=fabric)
    out = []
    for i in range(2):
        params, st, m = step(params, st, batch(i))
        out.append((float(m["loss"]), float(m["grad_norm"]), m["sync_dev"],
                    m["ag_replicas_equal"]))
    return out, _flat(params), st.mu, st.nu


@pytest.mark.parametrize("quantize", (False, True))
def test_world1_nccl_zero1_equals_stacked(nccl, quantize):
    want = _steps(nccl, None, quantize)
    got = _steps(nccl, dist.group.WORLD, quantize)
    assert got[0] == want[0] and all(m[3] for m in got[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_world1_nccl_reshard_and_degraded_step_equal_stacked(nccl):
    api, params, batch = _model(nccl)
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    rt = fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")
    size = sum(p.numel() for p in tree_leaves(params))
    dead = sorted(rt.entries[0].sched.trees[0].tree)[0]
    sid = rt.on_failure(FailureEvent(links=frozenset({dead})),
                        prefer="degraded").active
    fabric = ProcessGroupFabric(16, nccl)
    res = {}
    for name, group, fab in (("stacked", None, None),
                             ("nccl", dist.group.WORLD, fabric)):
        step = make_train_step(api, opt, SHAPE, NAMES, zero1=True,
                               fault_runtime=rt, group=group)
        st = ShardedAdamW(opt).init_for(params, rt, 16, fabric=fab)
        p, st, _ = step(params, st, batch(0), 0)
        mu = rt.reshard_owned(st.mu, 0, sid, size, fab)
        back = rt.reshard_owned(mu, sid, 0, size, fab)
        assert torch.equal(back, st.mu), name
        st = type(st)(st.step, mu, rt.reshard_owned(st.nu, 0, sid, size, fab))
        p, st, m = step(p, st, batch(1), sid)
        res[name] = (float(m["loss"]), float(m["grad_norm"]), _flat(p),
                     st.mu, st.nu, mu)
    a, b = res["nccl"], res["stacked"]
    assert a[:2] == b[:2]
    for x, y in zip(a[2:], b[2:]):
        assert torch.equal(x, y)
