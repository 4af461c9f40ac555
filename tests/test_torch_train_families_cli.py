"""The train and elastic entry points for every token family, on the CPU.

``launch.train`` trains reduced rwkv6-7b, recurrentgemma-2b and
olmoe-1b-7b on the 2x2 torus (``--mesh 2,2,1``) under ``--sync edst``
and ``--sync gspmd`` with finite losses (and, for the MoE, finite aux
metrics); ``--trace-out`` under ``gspmd`` prints the reference's
"skipped" line; the encdec and vlm configs are refused, their family
named, before a parameter is built.  A reduced rwkv6-7b checkpoint of
the train entry point is resharded through ``launch.elastic --to-mesh
2,4,1`` (restored bit for bit) and resumed there, its losses those of
the same steps continued from the saved state in memory, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.steps import make_train_step
from repro_torch.launch import elastic, train
from repro_torch.models.api import build
from repro_torch.optim import AdamW, cosine_schedule


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = ["--reduced", "--device", "cpu", "--mesh", "2,2,1", "--steps", "2",
        "--batch", "8", "--seq", "64", "--log-every", "100"]
ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "olmoe-1b-7b")


@pytest.mark.parametrize("sync", ["edst", "gspmd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_every_token_family(arch, sync):
    res = train.main(["--arch", arch, "--sync", sync] + BASE)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert all(np.isfinite(res.grad_norms))
    aux = {"moe_load_balance", "moe_router_z"}
    if arch == "olmoe-1b-7b":
        assert aux <= set(res.metrics)
        assert all(np.isfinite(float(res.metrics[k])) for k in aux)
    else:
        assert not aux & set(res.metrics)


def test_gspmd_trace_out_is_skipped(tmp_path, capsys):
    out = tmp_path / "sync.json"
    train.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                "--mesh", "2,2,1", "--sync", "gspmd", "--steps", "1",
                "--batch", "4", "--seq", "8", "--trace-out", str(out)])
    assert "[train] --trace-out skipped: no compiled EDST sync program " \
           "on this mesh/sync mode" in capsys.readouterr().out
    assert not out.exists()


@pytest.mark.parametrize("arch,family", [("seamless-m4t-large-v2", "encdec"),
                                         ("internvl2-2b", "vlm")])
def test_train_cli_refuses_the_families_without_a_token_stream(
        arch, family, monkeypatch):
    def built(*args, **kw):
        raise AssertionError("a model was built")

    monkeypatch.setattr(train, "build", built)
    monkeypatch.setattr(train, "resolve_device", built)
    with pytest.raises(SystemExit, match=f"{arch} is of the {family} "
                                         "family"):
        train.main(["--arch", arch] + BASE)


def test_rwkv6_checkpoint_reshards_and_resumes(tmp_path, capsys):
    """Train 2 steps on the 4x4 torus and checkpoint; the elastic CLI
    restores the checkpoint onto the 2x4 torus bit for bit; the train
    entry point resumes there for 2 more steps, whose losses are those of
    the saved state stepped on the 2x4 torus in memory."""
    ck = str(tmp_path / "ck")
    common = ["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
              "--batch", "16", "--seq", "16", "--sync", "edst",
              "--log-every", "100", "--ckpt-dir", ck]
    first = train.main(common + ["--mesh", "4,4,1", "--steps", "2"])
    params, opt_state, step = elastic.main(
        ["--ckpt-dir", ck, "--to-mesh", "2,4,1", "--arch", "rwkv6-7b",
         "--reduced", "--device", "cpu"])
    assert "resumed step 2 onto mesh (2, 4, 1); EDST schedule rebuilt " \
           "with k=1 trees" in capsys.readouterr().out
    assert step == 2
    assert elastic.same_state(params, opt_state, first.params,
                              first.opt_state)
    resumed = train.main(common + ["--mesh", "2,4,1", "--steps", "4"])
    assert resumed.start_step == 2 and len(resumed.losses) == 2

    cfg = configs.get("rwkv6-7b").reduced()
    stream = SyntheticLMStream(cfg.vocab, 16, 16, seed=0)
    step_fn = make_train_step(build(cfg), AdamW(cosine_schedule(3e-4, 20, 4)),
                              (2, 4, 1), ("pod", "data", "model"),
                              mode="edst")
    losses = []
    for i in (2, 3):
        params, opt_state, met = step_fn(params, opt_state, {
            "tokens": torch.as_tensor(stream.batch(i), dtype=torch.long)})
        losses.append(float(met["loss"]))
    assert resumed.losses == losses
