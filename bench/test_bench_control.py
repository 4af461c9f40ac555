"""The controls come out not correct under the cells' own limits: the
plain reference one precision step below what the configuration states,
put in the program's place.  On the CPU at a tiny size; on the card
(``gpu``) at each one-chip cell's own size."""
import pytest
import torch

import harness
import weights
from bench_tiny import SEED, TINY_LM, TINY_MOE, TINY_TRAIN
from reference import allreduce as ref_allreduce

CONTROL_SEED = 2 ** 31 + 977


def _train_readings(name, config, traffic, dev, seed):
    """The program's and the fp8 control's numbers against the f32
    reference, for one seed."""
    harness.program_path()
    T = harness.load_kind("train")
    run, zeros, shapes, n = T.build(config, traffic, dev)
    params, state, prog, first, moved, _ = T.first_steps(
        run.step_fn, zeros, shapes, seed, dev, config, traffic, n)
    del params, state, run, zeros
    ref = T.reference_readings(config, traffic, shapes, seed, dev, n,
                               traffic["ref_steps"])
    c = T.reference_readings(config, traffic, shapes, seed, dev, n,
                             traffic["ref_steps"], precision="fp8")
    sound = dict(T.gaps(prog, first, moved, ref))
    control = dict(T.gaps({"loss": c["loss"], "grad_norm": c["grad_norm"],
                           "routes": c["routes"]},
                          c["first_grad"], c["moved"], ref))
    return sound, control


def _fails(readings, limits) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name,config", [
    ("smollm-135m.train.edst", TINY_LM), ("olmoe-1b-7b.train.edst", TINY_MOE)])
def test_train_control_on_the_cpu(name, config):
    sound, control = _train_readings(name, config, TINY_TRAIN,
                                     torch.device("cpu"), SEED)
    limits = harness.limits_for(name)
    assert not _fails(sound, limits)
    assert _fails(control, limits), (control, limits)


def test_allreduce_control_on_the_cpu():
    width = 4099

    def fill(v, buf):
        weights.payload_row(SEED, v, width, "cpu", out=buf)
    ref = ref_allreduce.row_sum(fill, 16, width, "cpu")
    control = ref_allreduce.row_sum(fill, 16, width, "cpu", torch.bfloat16)
    limit = harness.limits_for("smollm-135m.sync.edst")["max_rel_err"]
    assert ref_allreduce.max_rel_err(control[None], ref) > limit


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["smollm-135m.train.edst",
                                  "olmoe-1b-7b.train.edst"])
def test_train_control_on_the_card(name):
    """The cell's own sizes, one seed: ~1-2 minutes on an H100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, config, traffic = harness.find_cell(harness.load_benchmark(), name)
    sound, control = _train_readings(name, config, traffic,
                                     torch.device("cuda", 0), CONTROL_SEED)
    limits = harness.limits_for(name)
    assert not _fails(sound, limits), (sound, limits)
    assert _fails(control, limits), (control, limits)


@pytest.mark.gpu
def test_allreduce_control_on_the_card():
    """smollm-135m's (16, P) payload, one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = "smollm-135m.sync.edst"
    _, config, _ = harness.find_cell(harness.load_benchmark(), name)
    harness.program_path()
    A = harness.load_kind("allreduce")
    dev = torch.device("cuda", 0)
    width = A.payload_width(config)

    def fill(v, buf):
        weights.payload_row(CONTROL_SEED, v, width, dev, out=buf)
    ref = ref_allreduce.row_sum(fill, 16, width, dev)
    control = ref_allreduce.row_sum(fill, 16, width, dev, torch.bfloat16)
    limit = harness.limits_for(name)["max_rel_err"]
    assert ref_allreduce.max_rel_err(control[None], ref) > limit


@pytest.mark.parametrize("kind", ["train", "allreduce"])
def test_calibration_reads_every_side(kind, tmp_path):
    """``calibrate.py``'s readings at a tiny size on the CPU: the program on
    every seed, the control and each fault on the first."""
    import json

    import calibrate
    from bench_tiny import TINY_ALLREDUCE
    harness.program_path()
    harness.load_kind(kind)
    out = tmp_path / "calib.jsonl"
    seeds = [SEED, SEED + 1]
    if kind == "train":
        calibrate.train_cell("t", TINY_MOE, TINY_TRAIN, seeds, 1, out, "cpu")
        faults = {"fault_half", "fault_exchange", "fault_unchanged"}
    else:
        calibrate.allreduce_cell("a", TINY_LM, TINY_ALLREDUCE, seeds, 1, out,
                                 "cpu")
        faults = {"fault_half", "fault_exchange", "fault_unchanged",
                  "fault_altered"}
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["seed"] for r in rows if r["side"] == "program"] == seeds
    assert {r["side"] for r in rows} == {"program", "control"} | faults
    if kind == "train":
        control = next(r for r in rows if r["side"] == "control")
        assert control["route_mismatch"] > 0
