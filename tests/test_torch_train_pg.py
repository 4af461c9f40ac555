"""``launch/train.py`` over 4 gloo ranks under the environment ``torchrun``
sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; the group itself comes
from a ``file://`` store under the test's temporary directory, so parallel
test workers share no port), against the stacked run of this process.

The reduced smollm-135m trains 2 steps on the 4x4 torus (``--mesh
4,4,1``, 4 vertices a rank) and the 2x2 torus (``2,2,1``, one a rank).
``edst`` must equal the stacked run's losses, grad norms and parameters
bit for bit.  ``psum_dp`` (a local sum, then ``all_reduce``) and
``gspmd`` (DTensor parameters on the ranks' one ``data`` axis, each
rank's rows of the batch, the gradients reduce-scattered onto the FSDP
shards) associate the gradient's sum otherwise: each must stay within the stacked ``psum_dp``'s
first-step grad-norm limit (1e-6, f32), and its mean gradient within 1e-6
of the largest element of ``psum_dp``'s (the limit the stacked
``grad_accum`` test holds); ``psum_dp``'s first step must move the
parameters as the stacked one does (2 lr at most, 1e-6 for all but 1e-3
of them).  Every rank must end with the same parameters.  (``gspmd``'s
move is not compared: on these inputs it differs from ``psum_dp``'s by a
few f32 roundings of the parameters, 1.5e-5 of its size for the stacked
``gspmd`` and 2.0e-5 over the ranks, past the 1e-5 that ``edst`` meets.)
A world size above the data extent and, under the manual sync modes, a
model axis above 1 are refused before anything is built
(``tests/test_torch_gspmd_pg.py`` runs gspmd on a model axis).  (``--zero1``, ``--recover`` and
``--trace-out`` run over the ranks: ``tests/test_torch_recover_pg.py``
and ``tests/test_torch_zero1_pg.py`` hold them to the stacked run.)
"""
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.steps import make_train_step
from repro_torch.launch import train
from repro_torch.models.api import build
from test_torch_fabric_pg import one_thread, spawn_ranks

WORLD = 4
BASE = ["--reduced", "--steps", "2", "--batch", "16", "--seq", "16",
        "--device", "cpu", "--log-every", "1"]
MESHES = {"4,4,1": (4, 4, 1), "2,2,1": (2, 2, 1)}
NAMES = ("pod", "data", "model")
RUNS = {(mesh, sync): ["--mesh", mesh, "--sync", sync]
        for mesh in MESHES for sync in ("edst", "psum_dp", "gspmd")}
REFUSED = {"data extent": ["--mesh", "2,1"],
           "model axis": ["--mesh", "2,2,2"]}


def _flat(tree):
    return torch.cat([p.detach().reshape(-1) for p in train.tree_leaves(tree)])


class _GradOut:
    """An optimizer whose update returns the mean gradient as the new
    parameters, so a step hands back what its sync computed."""

    def init(self, params):
        return None

    def apply(self, params, grads, state):
        return grads, state, {"grad_norm": torch.zeros(()),
                              "lr": torch.zeros(())}


def _mean_grad(mesh, mode, group=None):
    """The first step's synced mean gradient of ``train.main``'s first
    step (the same init and batch) under ``mode``."""
    cfg = configs.get("smollm-135m").reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    batch = {"tokens": torch.as_tensor(
        SyntheticLMStream(cfg.vocab, 16, 16, seed=0).batch(0),
        dtype=torch.long)}
    step = make_train_step(api, _GradOut(), MESHES[mesh], NAMES, mode=mode,
                           group=group)
    return _flat(step(params, None, batch)[0])


def _result(res):
    return {"losses": res.losses, "grad_norms": res.grad_norms,
            "init": _flat(res.init_params),
            "first": _flat(res.first_step_params),
            "params": _flat(res.params)}


def _train_rank(rank, world, init, out_dir):
    """One rank: every run of ``RUNS`` through ``train.main`` and every
    refusal's message, written to ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = {key: _result(train.main(BASE + argv, keep_first_step=True))
               for key, argv in RUNS.items()}
        for mesh in MESHES:
            for mode in ("gspmd", "psum_dp"):
                out[mode + " grad", mesh] = _mean_grad(mesh, mode,
                                                       dist.group.WORLD)
        for what, argv in REFUSED.items():
            try:
                train.main(BASE + argv)
            except SystemExit as e:
                out[what] = str(e.code)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("train_pg"), _train_rank)


@pytest.fixture(scope="module")
def stacked():
    assert "WORLD_SIZE" not in os.environ
    with one_thread():
        return {key: _result(train.main(BASE + argv, keep_first_step=True))
                for key, argv in RUNS.items()}


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_edst_ranks_equal_the_stacked_run(ranks, stacked, mesh):
    want = stacked[(mesh, "edst")]
    for r, got in enumerate(ranks):
        got = got[(mesh, "edst")]
        assert got["losses"] == want["losses"], r
        assert got["grad_norms"] == want["grad_norms"], r
        for key in ("init", "first", "params"):
            assert torch.equal(got[key], want[key]), (r, key)


@pytest.mark.parametrize("sync", ("edst", "psum_dp", "gspmd"))
@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_every_rank_ends_with_the_same_parameters(ranks, mesh, sync):
    first = ranks[0][(mesh, sync)]
    assert all(v == v for v in first["losses"])
    for got in ranks[1:]:
        got = got[(mesh, sync)]
        assert got["losses"] == first["losses"]
        assert torch.equal(got["params"], first["params"])


@pytest.mark.parametrize("mode", ("psum_dp", "gspmd"))
@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_within_stacked_psum_dp_limits(ranks, stacked, mesh, mode):
    """Over the ranks, the first step's loss equal to the stacked
    psum_dp's, its grad norm within 1e-6 of it, and the mean gradient
    within 1e-6 of its largest element."""
    psum = stacked[(mesh, "psum_dp")]
    with one_thread():
        want = _mean_grad(mesh, "psum_dp")
    for r in ranks:
        got = r[(mesh, mode)]
        assert torch.equal(got["init"], psum["init"])
        if mode == "psum_dp":   # the same per-vertex passes as stacked
            assert got["losses"][0] == psum["losses"][0]
        gn = abs(got["grad_norms"][0] - psum["grad_norms"][0]) \
            / psum["grad_norms"][0]
        assert gn <= 1e-6, gn
        g = r[mode + " grad", mesh]
        err = float((g - want).abs().max() / want.abs().max())
        assert err <= 1e-6, err


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_psum_dp_moves_as_the_stacked_run(ranks, stacked, mesh):
    """psum_dp's first step over the ranks moves the parameters as the
    stacked step does, within f32 rounding of the summed gradient: Adam's
    first step is about lr * sign(grad), so a gradient within rounding of
    zero may move either way (2 lr bounds those few, the rest agree to
    1e-6, as the stacked step is held to the reference's)."""
    want = stacked[(mesh, "psum_dp")]
    lr = float((want["first"] - want["init"]).abs().max())
    for r in ranks:
        got = r[(mesh, "psum_dp")]
        diff = (got["first"] - want["first"]).abs()
        assert float(diff.max()) <= 2 * lr + 1e-6
        assert float((diff > 1e-6).float().mean()) < 1e-3


@pytest.mark.parametrize("what", tuple(REFUSED))
def test_refused_over_ranks(ranks, what):
    for got in ranks:
        assert what in got, f"{what} was not refused"
        word = {"data extent": "data-parallel extent",
                "model axis": "model axis"}[what]
        assert word in got[what], got[what]
