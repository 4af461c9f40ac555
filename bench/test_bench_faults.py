"""``correct`` comes out false when the timed path is broken underneath:
each fault a cell can have, planted in the program, through the rest of
a run (everything but the look for a card) at a tiny size on the CPU,
under the cell's own limits.  A sound run comes out true."""
import pytest

from bench_tiny import (TINY_ALLREDUCE, TINY_LM, TINY_MOE, TINY_TRAIN,
                        run_tiny)

TRAIN = {"lm": ("smollm-135m.train.edst", TINY_LM),
         "moe": ("olmoe-1b-7b.train.edst", TINY_MOE)}


def _unchanged(step):
    """The step's state comes back as it went in."""
    def broken(params, opt_state, batch):
        return params, opt_state, step(params, opt_state, batch)[2]
    return broken


def _half(step):
    """Half the batch left out: the first half's rows stand in for the
    second's, so the mean is taken over the first half alone."""
    def broken(params, opt_state, batch):
        t = batch["tokens"]
        h = t.shape[0] // 2
        return step(params, opt_state, {"tokens": t[:h].repeat(2, 1)})
    return broken


def _altered(step):
    """The answer altered where it is produced: each loss 1% high."""
    def broken(params, opt_state, batch):
        p, s, m = step(params, opt_state, batch)
        return p, s, dict(m, loss=m["loss"] * 1.01)
    return broken


@pytest.mark.parametrize("model", sorted(TRAIN))
def test_train_sound_run_is_correct(model):
    name, config = TRAIN[model]
    assert run_tiny("train", config, TINY_TRAIN, name)["correct"]


@pytest.mark.parametrize("model", sorted(TRAIN))
@pytest.mark.parametrize("fault", [_unchanged, _half],
                         ids=["unchanged", "half"])
def test_train_fault_is_not_correct(model, fault):
    name, config = TRAIN[model]
    assert not run_tiny("train", config, TINY_TRAIN, name,
                        plant=fault)["correct"]


def test_train_altered_loss_is_not_correct():
    """smollm-135m's cell compares each step's loss (olmoe-1b-7b's loss
    gap has no upper reading, so its cell does not)."""
    name, config = TRAIN["lm"]
    assert not run_tiny("train", config, TINY_TRAIN, name,
                        plant=_altered)["correct"]


@pytest.mark.parametrize("model", sorted(TRAIN))
def test_train_without_the_exchange_is_not_correct(model, monkeypatch):
    """The exchange between vertices left out: each keeps its own
    gradient."""
    import harness
    harness.program_path()
    from repro_torch.dist import steps
    monkeypatch.setattr(steps, "tree_allreduce",
                        lambda g, *a, **k: g.clone())
    name, config = TRAIN[model]
    assert not run_tiny("train", config, TINY_TRAIN, name)["correct"]


class Broken:
    """A fault in the allreduce call, picklable for spawned ranks."""

    def __init__(self, fault):
        self.fault = fault

    def __call__(self, call, fabric):
        import torch

        def broken(x):
            if self.fault == "unchanged":
                return x.clone()
            if self.fault == "half":
                n = fabric.n
                return (2 * x[:n // 2].sum(0)).expand_as(x).clone()
            if self.fault == "exchange":    # each card's four rows alone
                blocks = x.reshape(-1, 4, x.shape[1]).sum(1, keepdim=True)
                return blocks.expand(-1, 4, -1).reshape(x.shape).clone()
            if self.fault == "exchange_ranks":
                return x.sum(0, keepdim=True).expand_as(x).clone()
            y = call(x)
            y[0, 7] += torch.ones((), dtype=y.dtype)
            return y
        return broken


def test_allreduce_sound_run_is_correct():
    assert run_tiny("allreduce", TINY_LM, TINY_ALLREDUCE,
                    "smollm-135m.sync.edst")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange",
                                   "altered"])
def test_allreduce_fault_is_not_correct(fault):
    assert not run_tiny("allreduce", TINY_LM, TINY_ALLREDUCE,
                        "smollm-135m.sync.edst",
                        plant=Broken(fault))["correct"]


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("exchange_ranks", False)])
def test_allreduce_over_four_ranks(fault, correct):
    """The four-card cell's path on four gloo ranks: sound, and with the
    exchange between the ranks left out."""
    traffic = dict(TINY_ALLREDUCE, ranks=4)
    res = run_tiny("allreduce", TINY_LM, traffic,
                   "smollm-135m.sync.edst-nccl4",
                   plant=None if fault is None else Broken(fault))
    assert res["correct"] is correct
    assert res["device"]["count"] == 4
