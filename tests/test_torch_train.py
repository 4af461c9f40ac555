"""The port's optimizer and train step against the reference.

AdamW is held against ``repro.optim.AdamW`` step for step on the same
gradients.  One reduced ``smollm-135m`` training step on ``--mesh 4,4,1``
(16 data-parallel vertices) is held against the reference's
``make_train_step`` run under ``shard_map`` on 16 fake host devices (a
subprocess), for ``psum_dp`` and ``edst`` (with each of the three
engines), from the reference's key-0 parameters and the same batch; every
``edst`` engine equals ``psum_dp``, and streaming the pipelined engine in
segments changes nothing.  Also: the train entry point's engine, profiler
and metrics options, the port's modules load neither JAX nor the
reference package, and the train entry point raises without a CUDA device
unless the CPU is asked for.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.dist.steps import (dp_fabric_for_mesh, edst_spec_for_mesh,
                                    make_train_step)
from repro_torch.launch import train as ttrain
from repro_torch.models.api import build
from repro_torch.optim import AdamW as TAdamW
from repro_torch.optim import cosine_schedule as t_cosine
from repro_torch.optim.adamw import tree_leaves

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU tensors run fastest on one thread (and leave the cores to
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH, NAMES = (4, 4, 1), ("pod", "data", "model")


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict)
                else rng.randn(*v).astype(np.float32))
            for k, v in shapes.items()}


@pytest.mark.parametrize("warmup,total", [(2, 5), (20, 100)])
def test_adamw_matches_reference_step_for_step(warmup, total):
    rng = np.random.RandomState(warmup)
    shapes = {"w": (5, 3), "b": {"scale": (3,), "k": (2, 2, 2)}}
    params = _tree(rng, shapes)
    jopt = JAdamW(j_cosine(1e-2, warmup, total))
    topt = TAdamW(t_cosine(1e-2, warmup, total))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        grads = _tree(rng, shapes)
        if step == 2:   # a large gradient exercises the norm clip
            grads["w"] *= 50.0
        jp, js, jm = jopt.apply(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = topt.apply(tp, params_from_jax(grads), ts)
        assert ts.step == int(js.step) == step + 1
        for name in ("grad_norm", "lr"):
            assert abs(float(jm[name]) - float(tm[name])) <= \
                1e-6 * max(1.0, abs(float(jm[name])))
        mine = tree_leaves(tp) + tree_leaves(ts.mu) + tree_leaves(ts.nu)
        for a, b in zip(jax.tree.leaves((jp, js.mu, js.nu)), mine):
            assert np.max(np.abs(np.asarray(a) - b.numpy())) < 1e-6


TRAIN_CODE = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import AxisType
from repro import configs
from repro.models.api import build
from repro.optim import AdamW, cosine_schedule
from repro.dist.steps import make_train_step

cfg = configs.get('smollm-135m').reduced()
api = build(cfg)
params, _ = api.init(jax.random.PRNGKey(0))
tokens = np.load(OUT + '.in.npy')
mesh = jax.make_mesh((4, 4, 1), ('pod', 'data', 'model'),
                     axis_types=(AxisType.Auto,) * 3)
opt = AdamW(cosine_schedule(3e-4, 20, 100))
out = {'params': np.asarray(ravel_pytree(params)[0])}
for tag, mode, engine in (('psum_dp', 'psum_dp', 'pipelined'),
                          ('edst', 'edst', 'pipelined'),
                          ('edst-fused', 'edst', 'fused'),
                          ('edst-striped', 'edst', 'striped')):
    step = jax.jit(make_train_step(api, opt, mesh, mode=mode, engine=engine))
    new_p, _, met = step(params, opt.init(params),
                         {'tokens': jnp.asarray(tokens)})
    out[tag + '/params'] = np.asarray(ravel_pytree(new_p)[0])
    for k in ('loss', 'grad_norm', 'lr'):
        out[tag + '/' + k] = np.asarray(met[k])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference_step(subproc, tmp_path_factory):
    path = tmp_path_factory.mktemp("train") / "ref.npz"
    tokens = np.random.RandomState(5).randint(0, 256, (16, 33)).astype(
        np.int32)
    np.save(str(path) + ".in.npy", tokens)
    subproc(f"OUT = {str(path)!r}\n" + TRAIN_CODE, 16)
    return tokens, dict(np.load(path))


def _init_params(flat):
    """The reference's key-0 params, rebuilt from their ravel order."""
    from repro.models import transformer as jtr
    from repro import configs as jconfigs
    jp, _ = jtr.init_lm(jconfigs.get("smollm-135m").reduced(),
                        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    got = torch.cat([p.reshape(-1) for p in tree_leaves(params)]).numpy()
    assert np.array_equal(got, flat)   # same leaf order as ravel_pytree
    return params


def _port_step(mode, params, tokens, engine="pipelined", segments="auto"):
    cfg = tconfigs.get("smollm-135m").reduced()
    opt = TAdamW(t_cosine(3e-4, 20, 100))
    step = make_train_step(build(cfg), opt, MESH, NAMES, mode=mode,
                           engine=engine, segments=segments)
    new_p, _, met = step(params, opt.init(params),
                         {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    flat = torch.cat([p.reshape(-1) for p in tree_leaves(new_p)]).numpy()
    return flat, met


@pytest.mark.parametrize("mode", ["psum_dp", "edst", "edst-fused",
                                  "edst-striped"])
def test_train_step_matches_reference(reference_step, mode):
    tokens, ref = reference_step
    params = _init_params(ref["params"])
    sync, _, engine = mode.partition("-")
    flat, met = _port_step(sync, params, tokens, engine or "pipelined")
    assert abs(float(met["loss"]) - float(ref[mode + "/loss"])) < 1e-5
    assert abs(float(met["grad_norm"]) - float(ref[mode + "/grad_norm"])) \
        < 1e-5 * float(ref[mode + "/grad_norm"])
    assert float(met["lr"]) == pytest.approx(float(ref[mode + "/lr"]))
    # Adam's first step moves each parameter by about lr * sign(grad), so a
    # gradient within rounding of zero may move either way: 2 lr bounds
    # those few, the rest agree to 1e-6
    diff = np.abs(flat - ref[mode + "/params"])
    assert np.max(diff) <= 2 * float(ref[mode + "/lr"]) + 1e-6
    assert np.mean(diff > 1e-6) < 1e-3, mode


def test_edst_step_equals_psum_dp(reference_step):
    tokens, ref = reference_step
    params = _init_params(ref["params"])
    fe, me = _port_step("edst", params, tokens)
    fp, mp = _port_step("psum_dp", params, tokens)
    assert float(me["loss"]) == float(mp["loss"])
    assert np.max(np.abs(fe - fp)) <= 1e-6


@pytest.mark.parametrize("engine", ["fused", "striped"])
def test_edst_engines_equal_psum_dp(reference_step, engine):
    """The fused and striped engines' first step is psum_dp's (the same
    limit as the pipelined engine's, above)."""
    tokens, ref = reference_step
    params = _init_params(ref["params"])
    fe, me = _port_step("edst", params, tokens, engine)
    fp, mp = _port_step("psum_dp", params, tokens)
    assert float(me["loss"]) == float(mp["loss"])
    assert abs(float(me["grad_norm"]) - float(mp["grad_norm"])) \
        <= 1e-6 * float(mp["grad_norm"])
    assert np.max(np.abs(fe - fp)) <= 1e-6


def test_segments_do_not_change_the_step(reference_step):
    """The pipelined engine streamed in 4 segments gives the 1-segment
    step's parameters, bit for bit."""
    tokens, ref = reference_step
    params = _init_params(ref["params"])
    f1, m1 = _port_step("edst", params, tokens, segments=1)
    f4, m4 = _port_step("edst", params, tokens, segments=4)
    assert np.array_equal(f1, f4)
    assert float(m1["grad_norm"]) == float(m4["grad_norm"])


def test_dp_fabric_and_spec_for_mesh():
    sp, names = dp_fabric_for_mesh(MESH, NAMES)
    assert names == ("pod", "data") and sp.n == 16
    spec = edst_spec_for_mesh(MESH, NAMES)
    assert (spec.k, len(spec.waves)) == (2, 12)
    ring = edst_spec_for_mesh((16, 1), ("data", "model"))
    assert (ring.k, len(ring.waves), ring.q8_boundary) == (1, 16, 8)
    assert edst_spec_for_mesh(MESH, NAMES) is spec
    fused = edst_spec_for_mesh(MESH, NAMES, engine="fused")
    striped = edst_spec_for_mesh(MESH, NAMES, engine="striped")
    assert (fused.k, fused.num_collectives) == (2, 22)
    assert (striped.k, len(striped.waves)) == (2, 23)
    assert edst_spec_for_mesh(MESH, NAMES, engine="striped") is striped
    composed = edst_spec_for_mesh(MESH, NAMES, schedule="composed")
    assert composed.k == 2 and composed is not spec
    with pytest.raises(ValueError):
        edst_spec_for_mesh(MESH, NAMES, engine="ring")
    with pytest.raises(ValueError):
        dp_fabric_for_mesh((1, 4), ("data", "model"))


def test_train_cli_runs_on_cpu():
    res = ttrain.main(["--reduced", "--steps", "2", "--batch", "16",
                       "--seq", "16", "--mesh", "4,4,1", "--sync", "edst",
                       "--quantize-grads", "--device", "cpu"],
                      keep_first_step=True)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert len(res.grad_norms) == len(res.step_seconds) == 2
    moved = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(res.first_step_params),
                 tree_leaves(res.init_params))]
    assert min(moved) > 0.0     # the first step moved every parameter


def test_train_cli_engine_profile_and_metrics(tmp_path):
    """``--edst-engine``, ``--profile-dir`` (a Chrome trace with one
    ``train/step`` range a step and one ``edst/`` range a wave of the
    step's program) and ``--metrics-out`` (steps and the noted program)."""
    from repro_torch.telemetry import metrics
    metrics.reset()
    try:
        res = ttrain.main(["--reduced", "--steps", "2", "--batch", "16",
                           "--seq", "8", "--mesh", "4,4,1", "--sync", "edst",
                           "--edst-engine", "fused", "--device", "cpu",
                           "--profile-dir", str(tmp_path / "prof"),
                           "--metrics-out", str(tmp_path / "m.json")])
        dumped = json.loads((tmp_path / "m.json").read_text())
    finally:
        metrics.reset()
    assert all(np.isfinite(res.losses))
    with open(res.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    spec = edst_spec_for_mesh(MESH, NAMES, engine="fused")
    assert names.count("train/step0") == names.count("train/step1") == 1
    waves = [n for n in names if n.startswith("edst/")]
    assert len(waves) == 2 * spec.num_collectives
    assert waves[0] == "edst/t*/w0/reduce"
    steps = dumped["edst_train_steps_total"]["values"]
    assert steps == [{"labels": {"mode": "edst"}, "value": 2.0}]
    noted = dumped["edst_program_waves"]["values"]
    assert noted == [{"labels": {"engine": "fused"},
                      "value": float(spec.num_collectives)}]


def test_train_cli_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--reduced", "--steps", "1"])


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert len(mods) > 20, mods\n"
        "assert not bad, bad\n"
        "print('CLEAN', len(mods))\n")
    from conftest import SRC
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC,
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr


@pytest.mark.parametrize("extra", [["--sync", "edst"], ["--zero1"],
                                   ["--sync", "edst", "--recover"]],
                         ids=["edst", "zero1", "recover"])
def test_train_cli_leaves_no_tensor_in_a_reference_cycle(extra):
    """A run's tensors are freed by reference counting alone: none sits in
    a reference cycle, which only the cycle collector frees (a recursive
    closure over the flat gradient once held 538 MB a step on the card)."""
    import gc
    gc.collect()
    gc.disable()
    try:
        res = ttrain.main(["--reduced", "--steps", "1", "--batch", "16",
                           "--seq", "16", "--mesh", "4,4,1",
                           "--device", "cpu"] + extra)
        del res
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage
                if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not held, held
