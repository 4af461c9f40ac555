"""The family-agnostic train step against the reference, on the CPU.

One step of reduced rwkv6-7b, recurrentgemma-2b and olmoe-1b-7b on
``--mesh 4,4,1`` (16 data-parallel vertices) under ``psum_dp``, ``edst``
(pipelined), ``gspmd``, and ``psum_dp`` with ``grad_accum=2``, each held
against the reference's ``make_train_step(api, ...)`` (``shard_map`` on 16
fake host devices, a subprocess) from the reference's key-0 parameters
and the same numpy batch, with ``test_train_step_matches_reference``'s
limits.  The one exception is rwkv6's grad norm, held to 1e-4 relative
(it reads about 5e-5): the port's chunked WKV (``kernels/wkv6/ref.py``)
runs its f32 sums in another order than XLA's, and the within-chunk
decay factors ``exp(+-cumulative log w)`` amplify that rounding, so its
loss gradient holds to 1e-4 of ``jax.grad`` (``tests/test_torch_api.py``)
and not to 1e-5.  Every metric of the reference's step is returned, and
the MoE's ``moe_load_balance`` and ``moe_router_z`` (averaged over the
vertices) are within 1e-5 of the reference's, relative.

On the port alone: ``grad_accum=2`` gives ``grad_accum=1``'s loss and
mean gradient within 1e-6 (the MoE with its load-balance loss weighted
0: that loss is not a mean over tokens); the layer loops' remat (``cfg.remat``, the
reference's ``jax.checkpoint``) leaves every family's gradients bit for
bit as they are without it; ``gspmd`` reports zero sync telemetry and
refuses ``zero1`` and a fault runtime, as the reference does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.dist.steps import fault_runtime_for_mesh, make_train_step
from repro_torch.models import api as tapi
from repro_torch.models import layers as L
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH, NAMES = (4, 4, 1), ("pod", "data", "model")
ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "olmoe-1b-7b")
# tag -> (mode, grad_accum)
RUNS = {"psum_dp": ("psum_dp", 1), "edst": ("edst", 1),
        "gspmd": ("gspmd", 1), "psum_dp-accum2": ("psum_dp", 2)}
BATCH = 32       # 2 rows a vertex: grad_accum=2 takes microbatches of 1
GRAD_NORM_TOL = {"rwkv6-7b": 1e-4}     # relative; else 1e-5
AUX = ("moe_load_balance", "moe_router_z")

REF_CODE = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import AxisType
from repro import configs
from repro.models.api import build
from repro.optim import AdamW, cosine_schedule
from repro.dist.steps import make_train_step

mesh = jax.make_mesh((4, 4, 1), ('pod', 'data', 'model'),
                     axis_types=(AxisType.Auto,) * 3)
opt = AdamW(cosine_schedule(3e-4, 20, 100))
for arch in ARCHS:
    api = build(configs.get(arch).reduced())
    params, _ = api.init(jax.random.PRNGKey(0))
    tokens = jnp.asarray(np.load(OUT + arch + '.in.npy'))
    out = {'params': np.asarray(ravel_pytree(params)[0])}
    for tag, (mode, accum) in RUNS.items():
        step = jax.jit(make_train_step(api, opt, mesh, mode=mode,
                                       grad_accum=accum))
        new_p, _, met = step(params, opt.init(params), {'tokens': tokens})
        out[tag + '/params'] = np.asarray(ravel_pytree(new_p)[0])
        for k, v in met.items():
            out[tag + '/' + k] = np.asarray(v)
    np.savez(OUT + arch + '.npz', **out)
"""


def _tokens(arch):
    vocab = tconfigs.get(arch).reduced().vocab
    return np.random.RandomState(5).randint(0, vocab, (BATCH, 33)).astype(
        np.int32)


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    """``{arch: (tokens, reference arrays)}``; one subprocess for all."""
    out = str(tmp_path_factory.mktemp("families") / "ref-")
    for arch in ARCHS:
        np.save(out + arch + ".in.npy", _tokens(arch))
    subproc(f"OUT = {out!r}\nARCHS = {ARCHS!r}\nRUNS = {RUNS!r}\n"
            + REF_CODE, 16)
    return {arch: (_tokens(arch), dict(np.load(out + arch + ".npz")))
            for arch in ARCHS}


def _flat(tree) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1)
                      for p in tree_leaves(tree)]).numpy()


def _ref_params(arch, flat=None):
    """The reference's key-0 params of the reduced ``arch``, in the port's
    tree (checked against their ravel order when ``flat`` is given)."""
    jp, _ = japi.build(jconfigs.get(arch).reduced()).init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    if flat is not None:
        assert np.array_equal(_flat(params), flat)
    return params


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference(reference, arch, run):
    tokens, ref = reference[arch]
    params = _ref_params(arch, ref["params"])
    mode, accum = RUNS[run]
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    step = make_train_step(tapi.build(tconfigs.get(arch).reduced()), opt,
                           MESH, NAMES, mode=mode, grad_accum=accum)
    new_p, _, met = step(params, opt.init(params),
                         {"tokens": torch.as_tensor(tokens,
                                                    dtype=torch.long)})
    want = {k.split("/", 1)[1] for k in ref if k.startswith(run + "/")}
    assert set(met) == want - {"params"}, (set(met), want)
    g = float(ref[run + "/grad_norm"])
    assert abs(float(met["loss"]) - float(ref[run + "/loss"])) < 1e-5
    assert abs(float(met["xent"]) - float(ref[run + "/xent"])) < 1e-5
    assert abs(float(met["grad_norm"]) - g) < GRAD_NORM_TOL.get(arch,
                                                                1e-5) * g
    assert float(met["lr"]) == pytest.approx(float(ref[run + "/lr"]))
    for k in AUX if arch == "olmoe-1b-7b" else ():
        r = float(ref[run + "/" + k])
        assert np.isfinite(float(met[k]))
        assert abs(float(met[k]) - r) <= 1e-5 * abs(r), (k, met[k], r)
    # Adam's first step moves each parameter by about lr * sign(grad): 2 lr
    # bounds a gradient within rounding of zero, the rest agree to 1e-6
    diff = np.abs(_flat(new_p) - ref[run + "/params"])
    lr = float(ref[run + "/lr"])
    assert np.max(diff) <= 2 * lr + 1e-6
    assert np.mean(diff > 1e-6) < 1e-3, run


class _GradOut:
    """An optimizer whose update returns the mean gradient as the new
    parameters, so a step hands back what its sync computed."""

    def init(self, params):
        return None

    def apply(self, params, grads, state):
        return grads, state, {"grad_norm": torch.zeros(()),
                              "lr": torch.zeros(())}


@pytest.mark.parametrize("mode", ["psum_dp", "gspmd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_is_the_full_batch_gradient(arch, mode):
    """Two microbatches a vertex: the loss, the mean gradient and the
    loss's metrics within 1e-6 of one whole shard's (relative; the
    gradient to its largest element).  The MoE's load-balance loss is
    ``n_experts * mean(me * ce)``, a product of two means over the
    tokens, so a microbatch's is not the shard's (in the reference too,
    whose ``grad_accum`` run the step test above holds the port's to):
    here olmoe-1b-7b trains with ``aux_loss_weight=0`` and its
    ``moe_load_balance`` is not compared."""
    cfg = tconfigs.get(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, aux_loss_weight=0.0)
    api = tapi.build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.as_tensor(_tokens(arch), dtype=torch.long)}
    out = {}
    for accum in (1, 2):
        step = make_train_step(api, _GradOut(), MESH, NAMES, mode=mode,
                               grad_accum=accum)
        g, _, met = step(params, None, batch)
        out[accum] = (_flat(g), met)
    (g1, m1), (g2, m2) = out[1], out[2]
    assert np.max(np.abs(g2 - g1)) <= 1e-6 * np.max(np.abs(g1))
    assert set(m1) == set(m2)
    for k in set(m1) - {"grad_norm", "lr", "moe_load_balance"}:
        a, b = float(m1[k]), float(m2[k])
        assert abs(a - b) <= 1e-6 * abs(a), (k, a, b)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(api, _GradOut(), MESH, NAMES, mode=mode,
                        grad_accum=3)(params, None, batch)


def _layer_bodies(cfg) -> int:
    """The reference's ``jax.checkpoint`` sites a forward passes through:
    one a layer body, the rglru's three a pattern step (each rec or attn
    block and its MLP) and the encoder's and decoder's layers."""
    if cfg.family == "rglru":
        return 2 * cfg.n_layers
    return cfg.n_layers + cfg.n_dec_layers


@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_remat_leaves_gradients_bit_identical(name, monkeypatch):
    """Each reduced config with ``remat=True`` gives the loss and every
    gradient of ``remat=False``, bit for bit, while every layer body runs
    under ``torch.utils.checkpoint``; without a gradient (prefill,
    decode) nothing is checkpointed."""
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn)
        return checkpoint(fn, *args, **kw)

    checkpoint = L.checkpoint
    monkeypatch.setattr(L, "checkpoint", counted)
    base = tconfigs.get(name).reduced()
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.as_tensor(rng.randint(0, base.vocab, (2, 33)))}
    if base.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.randn(2, 32, base.d_model).astype(np.float32))
    if base.family == "vlm":
        batch["patches"] = torch.as_tensor(
            rng.randn(2, base.n_img_tokens, base.d_model).astype(np.float32))
    out = {}
    for remat in (False, True):
        api = tapi.build(dataclasses.replace(base, remat=remat))
        params = api.init(torch.Generator().manual_seed(0))
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        del calls[:]
        loss, _ = api.loss_fn(params, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves),
                      len(calls))
        with torch.no_grad():
            api.loss_fn(params, batch)
        assert len(calls) == out[remat][2]
    assert out[False][2] == 0
    assert out[True][2] == _layer_bodies(base)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_gspmd_telemetry_is_zero_and_it_refuses_the_manual_options():
    api = tapi.build(tconfigs.get("rwkv6-7b").reduced())
    params = api.init(torch.Generator().manual_seed(0))
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    batch = {"tokens": torch.as_tensor(_tokens("rwkv6-7b")[:8],
                                       dtype=torch.long)}
    step = make_train_step(api, opt, MESH, NAMES, mode="gspmd",
                           telemetry=True)
    _, _, met = step(params, opt.init(params), batch)
    assert (met["sync_dev"], met["sync_wire_bytes"],
            met["sync_schedule_id"]) == (0.0, 0.0, 0)
    assert met["sync_grad_norm"] == pytest.approx(float(met["grad_norm"]),
                                                  rel=1e-6)
    with pytest.raises(ValueError, match="zero1=True requires mode='edst'"):
        make_train_step(api, opt, MESH, NAMES, mode="gspmd", zero1=True)
    with pytest.raises(ValueError, match="fault_runtime requires"):
        make_train_step(api, opt, MESH, NAMES, mode="gspmd",
                        fault_runtime=fault_runtime_for_mesh(MESH, NAMES))
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(api, opt, MESH, NAMES, grad_accum=0)
