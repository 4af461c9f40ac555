"""ZeRO-1 on the card (marked ``gpu``; these skip without a CUDA device):
the zero1 step over the 4x4 torus's 16 stacked vertices, and a run
through the fault runtime with a link of tree 0 killed (flip to the
degraded class, ``reshard_owned`` of mu and nu), against the port's CPU
run of the same small case.  The loss is linear in the params, so every
vertex's gradient is its batch shard, computed exactly on either device,
and its norm stays under the clip; the f32 params and moments must then
be ``torch.equal``, and over the int8 gradient wire within 4 ulps of the
value.  Also the sharded checkpoint round trip on the card.  This file
imports neither JAX nor the reference:

    python -m pytest -q tests/test_torch_zero1_gpu.py
"""
import pytest
import torch

from repro_torch.ckpt import restore_sharded, save_sharded_checkpoint
from repro_torch.core.collectives import owner_element_map
from repro_torch.core.fault import FailureEvent
from repro_torch.dist.steps import (edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.kernels.tree_combine import kernel as K
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

pytestmark = pytest.mark.gpu

SHAPE, NAMES = (4, 4, 1), ("pod", "data", "model")
SIZES = {"w": (37, 41), "b": (29,)}      # 1546 elements, ragged stripes


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def linear(params, batch):
    """A loss whose gradient is exact on any device: each vertex's
    gradient is 1e-3 times the sum of its two batch rows."""
    loss = sum((batch[k].sum(0) * params[k]).sum() for k in params)
    return loss * 1e-3, {}


def _problem(dev):
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s, generator=g).to(dev) for k, s in
              SIZES.items()}
    batch = {k: torch.randn((32, *s), generator=g).to(dev) for k, s in
             SIZES.items()}
    return params, batch


def _opt():
    return AdamW(cosine_schedule(1e-2, 2, 20))


def _run(dev, quantize=False, kill=False, steps=3):
    """(params, opt state, grad norms) after ``steps`` zero1 steps on
    ``dev``; with ``kill`` through the fault runtime, a link of tree 0
    killed after two."""
    params, batch = _problem(dev)
    opt = _opt()
    codec = "full" if quantize else None
    if kill:
        rt = fault_runtime_for_mesh(SHAPE, NAMES, engine="striped")
        step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                               fault_runtime=rt, quantize=quantize,
                               codec=codec, loss=linear,
                               telemetry=True)
        st = ShardedAdamW(opt).init_for(params, rt, 16)
    else:
        step = make_train_step(None, opt, SHAPE, NAMES, zero1=True,
                               engine="striped", quantize=quantize,
                               codec=codec, loss=linear,
                               telemetry=True)
        st = ShardedAdamW(opt).init_for(
            params, edst_spec_for_mesh(SHAPE, NAMES, engine="striped"), 16)
    sid, norms = 0, []
    size = sum(p.numel() for p in tree_leaves(params))
    for s in range(steps):
        if kill and s == 2:
            dead = sorted(rt.entries[0].sched.trees[0].tree)[0]
            sid = rt.on_failure(FailureEvent(links=frozenset({dead})),
                                prefer="degraded").active
            mu = rt.reshard_owned(st.mu, 0, sid, size)
            assert torch.equal(rt.reshard_owned(mu, sid, 0, size), st.mu)
            st = type(st)(st.step, mu,
                          rt.reshard_owned(st.nu, 0, sid, size))
        args = (params, st, batch) + ((sid,) if kill else ())
        params, st, m = step(*args)
        assert m["ag_replicas_equal"]
        norms.append(float(m["grad_norm"]))
    return params, st, norms


def _ulps(a, b):
    a, b = a.cpu(), b.cpu()
    return float(((a - b).abs() / torch.finfo(torch.float32).eps
                  / b.abs().clamp(min=1e-30)).max())


@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_zero1_on_the_card_equals_the_cpu(quantize, kill):
    dev = _cuda()
    K.reset_launches()
    gp, gst, gn = _run(dev, quantize, kill)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tree_combine"] > 0
    if quantize:
        assert K.LAUNCHES["q8_pack_rows"] > 0
        assert K.LAUNCHES["q8_unpack_rows"] > 0
    cp, cst, cn = _run(torch.device("cpu"), quantize, kill)
    assert all(n < 1.0 for n in cn)     # the clip stays off
    pairs = list(zip(tree_leaves(gp), tree_leaves(cp))) + \
        [(gst.mu, cst.mu), (gst.nu, cst.nu)]
    for a, b in pairs:
        if quantize:
            assert _ulps(a, b) <= 4.0
        else:
            assert torch.equal(a.cpu(), b)
    for a, b in zip(gn, cn):
        assert abs(a - b) <= 1e-6 * b


def test_sharded_checkpoint_round_trip_on_the_card(tmp_path):
    dev = _cuda()
    params, st, _ = _run(dev, steps=2)
    spec = edst_spec_for_mesh(SHAPE, NAMES, engine="striped")
    size = sum(p.numel() for p in tree_leaves(params))
    emap = owner_element_map(spec, size)
    save_sharded_checkpoint(str(tmp_path), 2, params, st, emap, size)
    tmpl, _ = _problem(dev)
    p2, st2, at, _ = restore_sharded(str(tmp_path), tmpl, emap)
    assert at == 2 and st2.step == 2 and st2.mu.device.type == "cuda"
    assert torch.equal(st2.mu, st.mu) and torch.equal(st2.nu, st.nu)
    for a, b in zip(tree_leaves(p2), tree_leaves(params)):
        assert a.device.type == "cuda" and torch.equal(a, b)
