"""The train entry point's ZeRO-1, checkpoint and fault-loop options on the
CPU (reduced ``smollm-135m``, ``--mesh 4,4,1``): ``--zero1`` against
``psum_dp``'s first step; ``--ckpt-dir`` resume bit-identical to an
uninterrupted run, dense and sharded; ``--recover`` with no fault (held
to ``psum_dp``: its entry 0 stripes by ``rebalance_chunks``, so not bit
for bit the plain edst step), with a link killed from a step on (retry,
flip, the step redone on the degraded class), and with a node lost
(checkpoint and stop); the refusal of ``--recover`` with ``--zero1``, and
``--recover`` on the striped engine's int8 wire, which runs as the
reference's does."""
import numpy as np
import pytest
import torch

from repro_torch.ckpt import latest_step
from repro_torch.dist import health
from repro_torch.dist.steps import fault_runtime_for_mesh
from repro_torch.launch import train
from repro_torch.optim import ShardedOptState
from repro_torch.optim.adamw import tree_leaves

BASE = ["--reduced", "--batch", "16", "--seq", "16", "--mesh", "4,4,1",
        "--device", "cpu", "--log-every", "100"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


@pytest.fixture(scope="module")
def psum_first():
    res = train.main(BASE + ["--sync", "psum_dp", "--steps", "1"],
                     keep_first_step=True)
    return _flat(res.init_params), _flat(res.params), res.grad_norms[0]


def _held_to_psum(res, psum_first):
    p0, p1, gn = psum_first
    assert torch.equal(_flat(res.init_params), p0)
    d = _flat(res.first_step_params) - p0
    rel = float((d - (p1 - p0)).norm() / (p1 - p0).norm())
    assert rel <= 1e-5, rel
    assert abs(res.grad_norms[0] - gn) <= 1e-5 * gn


def test_zero1_cli(psum_first):
    res = train.main(BASE + ["--zero1", "--steps", "2"], keep_first_step=True)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert isinstance(res.opt_state, ShardedOptState)
    assert res.opt_state.step == 2 and res.opt_state.mu.shape[0] == 16
    # the default step reads nothing back to compare the allgathered rows
    assert "ag_replicas_equal" not in res.metrics
    _held_to_psum(res, psum_first)


@pytest.mark.parametrize("mode", [["--zero1"], ["--sync", "edst"]])
def test_resume_is_bit_identical(tmp_path, mode):
    full = train.main(BASE + mode + ["--steps", "3"])
    ck = str(tmp_path / "ck")
    first = train.main(BASE + mode + ["--steps", "2", "--ckpt-dir", ck,
                                      "--ckpt-every", "1"])
    assert first.losses == full.losses[:2]
    resumed = train.main(BASE + mode + ["--steps", "3", "--ckpt-dir", ck])
    assert resumed.start_step == 2 and resumed.losses == full.losses[2:]
    assert torch.equal(_flat(resumed.params), _flat(full.params))
    a, b = resumed.opt_state, full.opt_state
    assert a.step == b.step == 3
    for x, y in ((a.mu, b.mu), (a.nu, b.nu)):
        if isinstance(x, dict):
            x, y = _flat(x), _flat(y)
        assert torch.equal(x, y)


def test_recover_without_a_fault(tmp_path, psum_first):
    journal = tmp_path / "j.jsonl"
    res = train.main(BASE + ["--recover", "--steps", "2", "--journal-out",
                             str(journal)], keep_first_step=True)
    assert len(res.losses) == 2 and res.controller.schedule_id == 0
    assert res.controller.journal == [] and not journal.exists()
    assert res.metrics["sync_dev"] == 0.0
    assert res.metrics["sync_schedule_id"] == 0
    assert res.metrics["sync_wire_bytes"] > 0
    _held_to_psum(res, psum_first)


def _inject(monkeypatch, from_step, links_of):
    """Make every probe from ``from_step`` on read the links that
    ``links_of(plan)`` names as dead."""
    check = health.HealthMonitor.check

    def faulty(self, step, fault_mask=None, **kw):
        if step >= from_step:
            dead = links_of(self.plan)
            fault_mask = np.array([l not in dead for l in self.plan.links],
                                  np.float32)
        return check(self, step, fault_mask=fault_mask, **kw)

    monkeypatch.setattr(health.HealthMonitor, "check", faulty)


def test_recover_flips_on_a_link_kill(tmp_path, monkeypatch):
    rt = fault_runtime_for_mesh((4, 4, 1), ("pod", "data", "model"))
    s, d = sorted(rt.entries[0].sched.trees[0].tree)[0]
    _inject(monkeypatch, 1, lambda plan: {(s, d), (d, s)})
    journal = tmp_path / "j.jsonl"
    res = train.main(BASE + ["--recover", "--steps", "3", "--journal-out",
                             str(journal)])
    ctrl = res.controller
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert ctrl.schedule_id != 0
    assert not ctrl.runtime.entry.uses_link({(s, d)})
    (row,) = ctrl.journal_rows()
    assert (row["cause"], row["action"], row["step"]) == \
        ("link-kill", "flip", 1)
    assert journal.read_text().count("\n") == 1
    assert res.metrics["sync_schedule_id"] == ctrl.schedule_id


def test_recover_stops_on_a_node_loss(tmp_path, monkeypatch):
    def node3(plan):
        return {l for l in plan.links if 3 in l}

    _inject(monkeypatch, 1, node3)
    ck = str(tmp_path / "ck")
    res = train.main(BASE + ["--recover", "--steps", "4", "--ckpt-dir", ck])
    assert len(res.losses) == 1 and res.controller.state == "stalled"
    (row,) = res.controller.journal_rows()
    assert (row["cause"], row["action"]) == ("node-loss", "observe")
    assert latest_step(ck) == 1


def test_recover_with_zero1_is_refused():
    with pytest.raises(SystemExit):
        train.main(BASE + ["--recover", "--zero1", "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(BASE + ["--recover", "--sync", "psum_dp", "--steps", "1"])


def test_recover_with_the_striped_int8_wire_is_refused():
    """No longer refused: as the reference does, ``--recover`` runs with
    the striped engine's int8 wire.  Its rows agree (``sync_dev`` 0), so
    the controller reads no corruption and commits every step, as it does
    on the pipelined int8 wire."""
    res = train.main(BASE + ["--recover", "--quantize-grads", "--edst-engine",
                             "striped", "--steps", "2"])
    assert len(res.losses) == 2 and res.controller.journal == []
    assert float(res.metrics["sync_dev"]) == 0.0
    res = train.main(BASE + ["--recover", "--quantize-grads", "--steps", "1"])
    assert len(res.losses) == 1
