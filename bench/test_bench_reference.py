"""The plain references against the program at reduced sizes on the CPU:
the decoder's loss and gradients, its training steps, and the allreduce's
sum."""
import pytest
import torch

import harness
import weights
from bench_tiny import SEED, TINY_LM, TINY_MOE, TINY_TRAIN
from reference import allreduce as ref_allreduce
from reference import decoder

CONFIGS = {"lm": TINY_LM, "moe": TINY_MOE}


def _program(config):
    harness.program_path()
    import modelcfg
    from repro_torch.models.api import build
    return build(modelcfg.port_config(config))


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_loss_and_gradients_match_the_program(model):
    config = CONFIGS[model]
    api = _program(config)
    import modelcfg
    shapes = modelcfg.param_shapes(config)
    w = weights.make_params(shapes, SEED, "cpu")
    tokens = weights.tokens(SEED, 0, 4, 48, config["vocab_size"], "cpu")
    leaves = [p for _, p in weights.leaves(w)]
    for p in leaves:
        p.requires_grad_(True)
    want, _ = api.loss_fn(w, {"tokens": tokens})
    g_want = torch.autograd.grad(want, leaves)
    got = decoder.loss_fn(config, w, tokens)
    g_got = torch.autograd.grad(got, leaves)
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    for (path, _), a, b in zip(weights.leaves(w), g_got, g_want):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_training_steps_match_the_program(model):
    """The reference's three steps against the program's first steps
    from the same weights and batches: every number compared within
    f32 rounding."""
    config = CONFIGS[model]
    harness.program_path()
    T = harness.load_kind("train")
    dev = torch.device("cpu")
    run, opt_state, shapes, n = T.build(config, TINY_TRAIN, dev)
    _, _, prog, first, moved, _ = T.first_steps(
        run.step_fn, opt_state, shapes, SEED, dev, config, TINY_TRAIN, n)
    ref = T.reference_readings(config, TINY_TRAIN, shapes, SEED, dev, n, 3)
    for name, value in T.gaps(prog, first, moved, ref):
        assert value < 1e-4, (name, value)


def test_allreduce_sum_matches_the_program():
    harness.program_path()
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.steps import edst_spec_for_mesh
    from repro_torch.dist.tree_allreduce import tree_allreduce
    spec = edst_spec_for_mesh((4, 4, 1), ("pod", "data", "model"))
    width = 3001
    x = torch.stack([weights.payload_row(SEED, v, width, "cpu")
                     for v in range(16)])
    y = tree_allreduce(x, spec, StackedFabric(16, "cpu"))

    def fill(v, buf):
        weights.payload_row(SEED, v, width, "cpu", out=buf)
    ref = ref_allreduce.row_sum(fill, 16, width, "cpu")
    assert ref_allreduce.max_rel_err(y, ref) < 1e-6
    control = ref_allreduce.row_sum(fill, 16, width, "cpu", torch.bfloat16)
    assert ref_allreduce.max_rel_err(control[None], ref) > 1e-3
