"""The yardstick against hand counts: ``mfu.train``'s FLOPs, each
roofline's bytes and least time, the trace reduction, and the readers."""
import math

import pytest

import counts
import harness
import peaks
import tracecut
from bench_tiny import TINY_LM


def test_model_flops_smollm_by_hand():
    c = harness.load_json(harness.BENCH / "configs" / "smollm-135m.json")
    # per layer: q, o 576 x 576; k, v 576 x 192; gate, up, down 576 x 1536
    layer = 2 * 576 * 576 + 2 * 576 * 192 + 3 * 576 * 1536
    n = 30 * layer + 49152 * 576
    assert n == 134_479_872
    want = 6 * n + 12 * 30 * 576 * 2048
    assert counts.model_flops_per_token(c, 2048) == want
    assert abs(want * 524_288 / 645e12 - 1) < 0.01      # ~645 TFLOP a step


def test_model_flops_olmoe_counts_active_experts_only():
    c = harness.load_json(harness.BENCH / "configs" / "olmoe-1b-7b.json")
    attn = 4 * 2048 * 2048
    active = 8 * 3 * 2048 * 1024 + 2048 * 64       # 8 of 64 + the router
    n = attn + active + 50304 * 2048               # real vocabulary
    want = 6 * n + 12 * 1 * 16 * 128 * 4096
    assert counts.model_flops_per_token(c, 4096) == want
    assert abs(want / 1.12e9 - 1) < 0.01


def test_model_flops_tiny_by_hand():
    d, f, v, s = 64, 96, 256, 32
    n = 2 * (d * 16 * (2 * 4 + 2 * 2) + 3 * d * f) + v * d
    assert counts.model_flops_per_token(TINY_LM, s) == 6 * n + 12 * 2 * 64 * s


def test_allreduce_least_time_by_hand():
    p = 134_515_008
    s, bound = counts.allreduce_least_seconds(16, p, 1)
    assert bound == "hbm" and s == pytest.approx(2 * 16 * p * 4 / 3.35e12)
    s, bound = counts.allreduce_least_seconds(4, p, 4)
    link = 2 * 3 / 4 * p * 4 / 450e9
    hbm = 2 * 4 * p * 4 / 3.35e12
    assert bound == "link" and link > hbm and s == pytest.approx(link)


def test_combine_bytes_by_hand():
    """Each combine launch reads its two inputs and writes its output
    once: the pipelined f32 program on the 4x4 torus combines (16, m)
    chunk rows, so every launch moves 3 x 16 x m x 4 bytes."""
    import torch
    harness.program_path()
    from repro_torch.dist import tree_allreduce as T
    from repro_torch.dist.fabric import StackedFabric
    from repro_torch.dist.steps import edst_spec_for_mesh
    spec = edst_spec_for_mesh((4, 4, 1), ("pod", "data", "model"))
    width = 1001
    x = torch.randn(16, width)
    rec = counts.KernelBytes()
    with rec.recording(T, "combine"):
        y = T.tree_allreduce(x, spec, StackedFabric(16, "cpu"), segments=1)
    m = -(-width // spec.k)
    assert rec.launches > 0
    assert rec.bytes == rec.launches * 3 * 16 * m * 4
    assert torch.allclose(y, x.sum(0).expand_as(y), atol=1e-4)
    assert T.combine is not None and T.combine.__name__ == "combine"


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """A 100 us slice of two units: kernels at 10-30 (launched inside an
    edst range) and 50-60 and 55-70 (outside), idle elsewhere."""
    return [
        _ev("user_annotation", tracecut.SLICE, 0, 100),
        _ev("user_annotation", "bench/unit0", 0, 45),
        _ev("user_annotation", "bench/unit1", 45, 55),
        _ev("user_annotation", "edst/t0/w0/reduce", 5, 10),
        _ev("cpu_op", "aten::mm", 40, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 1, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 42, 1, 3),
        _ev("kernel", "void tree_combine_kernel<float, 1>", 10, 20, 1),
        _ev("kernel", "sm90_gemm", 50, 10, 2),
        _ev("kernel", "sm90_gemm", 55, 15, 3),
    ]


def test_trace_summary_by_hand():
    s = tracecut.summarize(synthetic_trace())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["units"] == 2
    assert s["busy_s"] == pytest.approx(40e-6)        # 10-30 and 50-70
    assert s["launched_s"] == pytest.approx(45e-6)
    assert s["launched_in"]["edst/"] == pytest.approx(20e-6)
    assert tracecut.kernel_seconds(s, "tree_combine_kernel") == \
        pytest.approx((20e-6, 1))
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "bench/unit#"                # 70-100
    assert gaps[1][0] == "bench/unit# | aten::mm"     # 30-50: the mm's host
    assert s["breakdown"]["device_ops"][0] == ["sm90_gemm",
                                               pytest.approx(25e-6)]


def test_readers_on_a_synthetic_context():
    s = tracecut.summarize(synthetic_trace())
    ctx = {"kind": "train", "setup_s": 3.0, "world": 1, "trace": s,
           "window": {"seconds": 2.0, "count": 4, "tokens": 4000},
           "counts": {"flops_per_token": 1e9,
                      "combine_bytes_per_unit": 1000}}

    def read(name):
        return harness.load_reader(name).read(ctx)
    assert read("train_tokens_per_s") == 2000
    assert read("mfu.train") == pytest.approx(100 * 4e12 / (989e12 * 2))
    assert read("idle_share.train") == pytest.approx(60.0)
    assert read("sync_share.train") == pytest.approx(20.0)
    assert read("compute_ms_per_step.train") == pytest.approx(25e-3 / 2)
    assert read("roofline.tree_combine.train") == pytest.approx(
        100 * (2 * 1000 / peaks.HBM_BYTES_PER_S) / 20e-6)
    assert read("idle_share.sync") is None
    assert read("allreduce_ms_p90") is None


def test_allreduce_readers_by_hand():
    ms = [float(i) for i in range(1, 101)]
    ctx = {"kind": "allreduce", "setup_s": 1.0, "world": 4, "trace": None,
           "window": {"seconds": 10.0, "count": 100, "call_ms": ms,
                      "payload_bytes": 4 * 1000},
           "counts": {"rows": 4, "width": 1000, "wire_bytes": 3e6}}

    def read(name):
        return harness.load_reader(name).read(ctx)
    assert read("allreduce_algbw_GBps") == pytest.approx(4000 * 100 / 10
                                                         / 1e9)
    assert read("allreduce_ms_p90") == pytest.approx(90.1)
    least = 2 * 3 / 4 * 4000 / 450e9
    assert read("allreduce_roofline.sync") == pytest.approx(
        100 * least / (statistics_mean(ms) / 1e3))
    assert read("wire_MB.sync") == 3.0
    assert read("roofline.tree_combine.sync") is None


def statistics_mean(xs):
    return math.fsum(xs) / len(xs)
