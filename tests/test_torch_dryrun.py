"""``python -m repro_torch.launch.dryrun`` on a 16x16 ``fake`` group (each
cell a subprocess: the group is process-wide) for reduced smollm-135m at
``train_4k``, ``prefill_32k`` and ``decode_32k``, against the reference's
``run_cell`` of the same reduced config on its own 16x16 placeholder mesh
(one subprocess; ``repro.launch.dryrun`` sets its ``XLA_FLAGS`` at
import), compiled and read by ``analyze_hlo``.

The JSON keys are the reference's, with the cell's trace seconds
(``trace_s``) in place of its lower and compile seconds, plus ``fits``
(the peak against the H100's 80 GB), ``roofline`` and
``memory.peak_bytes``.

Per-device dot FLOPs of ``train_4k``: the reduced config's 4 heads do not
divide the 16-wide model axis, so both packages compute each device's
attention whole on every model rank, but the reference's blockwise
``sdpa`` skips the key blocks above the diagonal (``q_block`` =
``kv_block`` = 64: of the 64 x 64 blocks of a 4096 sequence it computes
64 * 65 / 2) where the port's plain ``sdpa`` computes every (query, key)
product and masks the upper half.  Each package's attention is reckoned
exactly (four products per query, key and head dim -- QK^T and PV --
forward, twice that backward), and what remains, the projections'
products (6 per parameter and token), must lie for both between the
reckoning split 16 ways over the model axis and the whole: XLA and
DTensor's cost-based choice split different projections (the port more),
and XLA fuses and may rematerialize.

The reduced ``prefill_32k`` cell's peak is over 80 GB (the plain
version of the flash attention kernel, which the prefill takes on the
CPU, holds the (S, S) scores of every local head at S = 32768) and must
be reported as not fitting; the ``train_4k`` and ``decode_32k`` cells
fit.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch import configs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "smollm-135m"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
TIMEOUT = 240

REF_CODE = r"""
import dataclasses, functools, json, sys
import repro.launch.dryrun as D          # sets XLA_FLAGS at import
import jax
from jax.sharding import AxisType
from repro import configs
full = configs.get(ARCH)
red = full.reduced()
ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
      if getattr(red, f.name) != getattr(full, f.name)}
D.build_cell = functools.partial(D.build_cell, cfg_overrides=ov)
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
res = D.run_cell(ARCH, "train_4k", False, verbose=False)
print(json.dumps(res))
"""


def _popen(args, code=None):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    cmd = [sys.executable] + (["-c", code] if code else
                              ["-m", "repro_torch.launch.dryrun"] + args)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _wait(p):
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        pytest.fail(f"no exit within {TIMEOUT} s: {err[-2000:]}")
    return p.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``({shape: (rc, cell)}, reference cell)``: the port's three cells
    and the reference's, all four subprocesses at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {s: _popen(["--arch", ARCH, "--shape", s, "--reduced", "--out",
                        str(tmp / f"{s}.json")]) for s in SHAPES}
    ref = _popen(None, f"ARCH = {ARCH!r}\n" + REF_CODE)
    rc, out, err = _wait(ref)
    assert rc == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    got = {}
    for s, p in procs.items():
        rc, out, err = _wait(p)
        assert "[dryrun] done: 1/1 OK" in out, (out[-2000:], err[-3000:])
        cells = json.loads((tmp / f"{s}.json").read_text())
        got[s] = (rc, cells[0])
    return got, want


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_runs_with_the_reference_keys(runs, shape):
    got, want = runs
    rc, cell = got[shape]
    assert rc == 0
    assert set(cell) == set(want) - {"lower_s", "compile_s"} | {
        "trace_s", "fits", "roofline"}
    for key in ("collectives", "loop_aware"):
        assert set(cell[key]) == set(want[key])
    assert set(cell["collectives"]["counts"]) == \
        set(want["collectives"]["counts"])
    assert set(cell["memory"]) == set(want["memory"]) | {"peak_bytes"}
    assert (cell["arch"], cell["shape"], cell["mesh"]) == \
        (ARCH, shape, "16x16")
    assert cell["flops"] > 0 and cell["bytes_accessed"] > 0
    assert cell["collectives"]["total_bytes"] > 0
    assert cell["memory"]["peak_bytes"] >= cell["memory"]["argument_bytes"]
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")


def test_train_dot_flops_against_the_reference(runs):
    got, want = runs
    cfg = configs.get(ARCH).reduced()
    shape = cfg.shape("train_4k")
    b_loc = shape.global_batch // 16            # the data axis
    s, nq = shape.seq_len, shape.seq_len // cfg.q_block
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_
    attn = 4.0 * b_loc * s * s * h * hd * cfg.n_layers * 3
    proj = cfg.n_layers * (2 * d * h * hd + 2 * d * kv * hd
                           + 3 * d * cfg.d_ff) + cfg.vocab_padded * d
    whole = 6.0 * proj * b_loc * s
    port = got["train_4k"][1]["loop_aware"]["dot_flops"]
    ref = want["loop_aware"]["dot_flops"]
    rests = {"port": port - attn, "reference": ref - attn * (nq + 1) / (2 * nq)}
    for who, rest in rests.items():
        assert whole / 16 <= rest <= whole, (who, rest, whole)


def test_memory_held_against_80_gb(runs):
    got, _ = runs
    prefill = got["prefill_32k"][1]
    assert prefill["memory"]["peak_bytes"] > 80e9
    assert prefill["fits"] is False
    for shape in ("train_4k", "decode_32k"):
        cell = got[shape][1]
        assert cell["memory"]["peak_bytes"] < 80e9 and cell["fits"] is True
