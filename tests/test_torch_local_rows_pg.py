"""``layers.local_rows`` over 4 gloo ranks on a (2, 2) data x model mesh:
the chunked WKV (``kernels/wkv6/ref.py::wkv6_ref``, the recurrence the
rwkv6 loss runs), the associative RG-LRU scan and the blockwise ``sdpa``
run on each rank's rows of DTensor inputs, and each result (outputs and
the gradients of every input split by rows) is bit for bit the plain
function's on the whole batch.  The gradient of the WKV's whole ``u`` is
each rank's sum over its rows, added over the ranks: within 1e-6 of its
largest value of the one sum over the batch, in another order.

The inputs arrive as a model would hand them over: the batch split over
``data`` and the heads (or the width) over ``model``; the WKV's ``u`` and
the attention's positions whole.  Each rank redistributes them to its
rows with the heads whole, so the function runs on plain local tensors,
and the outputs come back batch-split.  A plain tensor beside DTensors
(the WKV's initial state) is cut to the rank's rows.  Each spawned rank
has its own timeout, so a hang fails the test instead of stalling the
suite.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models.rglru import rg_lru_scan

WORLD, MESH, NAMES = 4, (2, 2), ("data", "model")
B, T, H, N = 4, 100, 4, 8
JOIN_S = 120
CASES = ("wkv6", "rg_lru_scan", "sdpa")


def _inputs():
    rng = np.random.RandomState(5)

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    logw = -torch.exp(f(B, T, H, N) * 0.5 - 3.0)
    wkv = (f(B, T, H, N), f(B, T, H, N), f(B, T, H, N), logw,
           f(H, N) * 0.5, f(B, H, N, N))
    a = torch.sigmoid(f(B, T, H * N))
    scan = (a, f(B, T, H * N), f(B, H * N))
    att = (f(B, T, H, N), f(B, T, 2, N), f(B, T, 2, N))
    return {"wkv6": wkv, "rg_lru_scan": scan, "sdpa": att}


def _run(case, args):
    """(the function's tensor outputs, the gradients of ``args``)."""
    if case == "wkv6":
        fn, kw = wkv6_ref, {"whole": (4,)}
        s0 = args[5]
        if isinstance(s0, DTensor):
            s0 = s0.full_tensor()
        args = list(args[:5]) + [s0.detach()]           # a plain state
    elif case == "rg_lru_scan":
        fn, kw = rg_lru_scan, {}
    else:
        pos = torch.arange(T)
        cfg = L.AttnCfg(H * N, H, 2, N, window=40)

        def fn(q, k, v, qp, kp):
            return L._sdpa_blocks(q, k, v, qp, kp, None, cfg=cfg,
                                  mask_mode="causal", q_block=32,
                                  kv_block=16)
        args, kw = list(args) + [pos, pos], {"whole": (3, 4)}
    out = L.local_rows(fn, *args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs))
    leaves = [a for a in args if isinstance(a, torch.Tensor)
              and a.requires_grad]
    return outs, torch.autograd.grad(loss, leaves)


def _placed(case, x, i, mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    if case == "wkv6" and i == 4:                   # u: (H, N), heads split
        pl = [Replicate(), Shard(0)]
    elif case == "rg_lru_scan":                     # width split
        pl = [Shard(0), Shard(x.dim() - 1)]
    else:                                           # heads split
        pl = [Shard(0), Shard(2 if x.dim() == 4 else 1)]
    return distribute_tensor(x, mesh, pl).requires_grad_(True)


def _rank_main(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(MESH, NAMES)
        out = {}
        for case, args in _inputs().items():
            placed = [_placed(case, x, i, mesh) for i, x in enumerate(args)]
            outs, grads = _run(case, placed)
            out[case] = {
                "outs": [o.full_tensor().detach() for o in outs],
                "grads": [g.full_tensor() for g in grads],
                "placements": [tuple(str(p) for p in o.placements)
                               for o in outs]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("local_rows_pg")
    ctx = mp.get_context("spawn")
    init = f"file://{tmp / 'store'}"
    procs = [ctx.Process(target=_rank_main, args=(r, WORLD, init, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("case", CASES)
def test_local_rows_bit_for_bit_with_the_whole_batch(ranks, case):
    torch.set_num_threads(1)
    args = [x.clone().requires_grad_(True) for x in _inputs()[case]]
    want_outs, want_grads = _run(case, args)
    for r in ranks:
        got = r[case]
        assert len(got["outs"]) == len(want_outs)
        for g, w in zip(got["outs"], want_outs):
            assert g.shape == w.shape and torch.equal(g, w.detach())
        assert len(got["grads"]) == len(want_grads)
        for i, (g, w) in enumerate(zip(got["grads"], want_grads)):
            if case == "wkv6" and i == 4:
                # u's gradient: each rank's rows summed, then the ranks'
                # sums added, against one sum over the batch
                assert (g - w).abs().max() <= 1e-6 * w.abs().max()
            else:
                assert torch.equal(g, w)
        # the outputs come back split by rows over ``data`` only
        assert all(p == ("S(0)", "R") for p in got["placements"])
