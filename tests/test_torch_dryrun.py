"""``python -m repro_torch.launch.dryrun`` on a 16x16 ``fake`` group (each
cell a subprocess: the group is process-wide) for reduced smollm-135m at
``train_4k``, ``prefill_32k`` and ``decode_32k``, and for reduced
recurrentgemma-2b and rwkv6-7b at ``train_4k``, against the reference's
``run_cell`` of the same reduced configs on its own 16x16 placeholder mesh
with Auto axes (a subprocess each; ``repro.launch.dryrun`` sets its
``XLA_FLAGS`` at import), compiled and read by ``analyze_hlo``.

The JSON keys are the reference's, with the cell's trace seconds
(``trace_s``) in place of its lower and compile seconds, plus ``fits``
(the peak against the H100's 80 GB), ``roofline`` and
``memory.peak_bytes``.

Per-device dot FLOPs of smollm-135m's ``train_4k``: the reduced config's 4
heads do not divide the 16-wide model axis, so both packages compute each
device's attention whole on every model rank, and both packages' blockwise
``sdpa`` skip the key blocks above the diagonal (``q_block`` =
``kv_block`` = 64: of the 64 x 64 blocks of a 4096 sequence they compute
64 * 65 / 2).  Each package's attention is reckoned exactly over those
blocks: four products per query, key and head dim -- QK^T and PV --
forward, twice that backward, and in the port four more, as its
checkpointed block step runs both forward products again in the backward
(the reference's count reads as without that recompute).  What remains,
the projections' products (6 per parameter and token), must lie for both
between the reckoning split 16 ways over the model axis and the whole:
XLA and DTensor's cost-based choice split different projections (the port
more), and XLA fuses and may rematerialize.  recurrentgemma-2b's and
rwkv6-7b's cells read per-device dot FLOPs within a factor of 4 of the
reference's (the packages split different products, and the reference's
loop-aware count of the WKV and RG-LRU scans is its own), and both fit.

The reduced ``prefill_32k`` cell's peak is the blockwise attention's:
under 80 GB and below the (S, S) f32 scores of every local head at S =
32768 (34.4 GB), which a whole-score attention would hold; the
``train_4k`` and ``decode_32k`` cells fit too.
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
RECURRENT = ("recurrentgemma-2b", "rwkv6-7b")
CELLS = [(ARCH, s) for s in SHAPES] + [(a, "train_4k") for a in RECURRENT]
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
    """``({(arch, shape): (rc, cell)}, {arch: reference train_4k cell})``:
    the reference's three cells at once, then the port's five at once (so
    that no more than five processes share the cores)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    refs = {a: _popen(None, f"ARCH = {a!r}\n" + REF_CODE)
            for a in (ARCH,) + RECURRENT}
    want = {}
    for a, p in refs.items():
        rc, out, err = _wait(p)
        assert rc == 0, err[-3000:]
        want[a] = json.loads(out.strip().splitlines()[-1])
    procs = {(a, s): _popen(["--arch", a, "--shape", s, "--reduced",
                             "--out", str(tmp / f"{a}-{s}.json")])
             for a, s in CELLS}
    got = {}
    for (a, s), p in procs.items():
        rc, out, err = _wait(p)
        assert "[dryrun] done: 1/1 OK" in out, (out[-2000:], err[-3000:])
        cells = json.loads((tmp / f"{a}-{s}.json").read_text())
        got[a, s] = (rc, cells[0])
    return got, want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_runs_with_the_reference_keys(runs, arch, shape):
    got, want = runs
    rc, cell = got[arch, shape]
    want = want[arch]
    assert rc == 0
    assert set(cell) == set(want) - {"lower_s", "compile_s"} | {
        "trace_s", "fits", "roofline"}
    for key in ("collectives", "loop_aware"):
        assert set(cell[key]) == set(want[key])
    assert set(cell["collectives"]["counts"]) == \
        set(want["collectives"]["counts"])
    assert set(cell["memory"]) == set(want["memory"]) | {"peak_bytes"}
    assert (cell["arch"], cell["shape"], cell["mesh"]) == \
        (arch, shape, "16x16")
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
    # four FLOPs per (query, key) pair and head dim a pass, over the
    # causal blocks; forward + backward (twice the forward), and in the
    # port the block step's recompute
    pair = 4.0 * b_loc * s * s * (nq + 1) / (2 * nq) * h * hd * cfg.n_layers
    proj = cfg.n_layers * (2 * d * h * hd + 2 * d * kv * hd
                           + 3 * d * cfg.d_ff) + cfg.vocab_padded * d
    whole = 6.0 * proj * b_loc * s
    port = got[ARCH, "train_4k"][1]["loop_aware"]["dot_flops"]
    ref = want[ARCH]["loop_aware"]["dot_flops"]
    rests = {"port": port - pair * 4, "reference": ref - pair * 3}
    for who, rest in rests.items():
        assert whole / 16 <= rest <= whole, (who, rest, whole)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_cells_against_the_reference(runs, arch):
    got, want = runs
    cell = got[arch, "train_4k"][1]
    port = cell["loop_aware"]["dot_flops"]
    ref = want[arch]["loop_aware"]["dot_flops"]
    assert ref / 4 <= port <= ref * 4, (port, ref)
    assert cell["fits"] is True


def test_memory_held_against_80_gb(runs):
    got, _ = runs
    cfg = configs.get(ARCH).reduced()
    shape = cfg.shape("prefill_32k")
    b_loc = shape.global_batch // 16
    whole_scores = 4.0 * b_loc * cfg.n_heads * shape.seq_len ** 2
    prefill = got[ARCH, "prefill_32k"][1]
    assert prefill["memory"]["peak_bytes"] < min(80e9, whole_scores)
    assert prefill["fits"] is True
    for shape in ("train_4k", "decode_32k"):
        cell = got[ARCH, shape][1]
        assert cell["memory"]["peak_bytes"] < 80e9 and cell["fits"] is True
