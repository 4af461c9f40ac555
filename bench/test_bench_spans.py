"""``spans.py`` against hand counts: the program's span prefixes and
``idle_in`` on a synthetic trace of one step, the five numbers read from
them, and ``tracecut.summarize``'s own keys left as they were."""
import pytest

import spans
import tracecut
from test_bench_counts import _ev, synthetic_trace

US = 1e-6


def span_trace():
    """A 100 us slice of one step (one ``bench/unit0``).  Host ranges and
    the device work launched inside them (launch -> device interval):

    * ``step/forward/v0`` 0-10: a GEMM, 5 -> 10-25; ``step/forward/v1``
      10-20: nothing;
    * ``step/backward/v1`` 20-40: a kernel, 25 -> 30-40;
    * ``step/rows/v1`` 40-52: a copy, 45 -> 60-65;
    * ``step/sync`` 53-75 around ``edst/t0/w0/reduce`` 54-74, around
      ``fabric/zero`` 55-57 (a fill, 56 -> 66-68) and ``fabric/p2p`` 58-63
      (a send and receive, 60 -> 70-78);
    * ``step/optim`` 80-95: a kernel, 85 -> 90-94.

    Busy 44 us; idle 0-10, 25-30, 40-60, 65-66, 68-70, 78-90, 94-100."""
    ranges = [("bench/unit0", 0, 100), ("step/forward/v0", 0, 10),
              ("step/forward/v1", 10, 10), ("step/backward/v1", 20, 20),
              ("step/rows/v1", 40, 12), ("step/sync", 53, 22),
              ("edst/t0/w0/reduce", 54, 20), ("fabric/zero", 55, 2),
              ("fabric/p2p", 58, 5), ("step/optim", 80, 15)]
    work = [("kernel", "sm90_gemm", 5, 10, 15),
            ("kernel", "elementwise_kernel", 25, 30, 10),
            ("gpu_memcpy", "Memcpy DtoD", 45, 60, 5),
            ("gpu_memset", "Memset (Device)", 56, 66, 2),
            ("kernel", "ncclDevKernel_SendRecv", 60, 70, 8),
            ("kernel", "multi_tensor_apply_kernel", 85, 90, 4)]
    out = [_ev("user_annotation", tracecut.SLICE, 0, 100)]
    out += [_ev("user_annotation", n, ts, d) for n, ts, d in ranges]
    for corr, (cat, name, launch, ts, d) in enumerate(work, 1):
        out.append(_ev("cuda_runtime", "cudaLaunchKernel", launch, 1, corr))
        out.append(_ev(cat, name, ts, d, corr))
    return out


def test_span_summary_by_hand():
    s = spans.summarize(span_trace())
    assert s["busy_s"] == pytest.approx(44 * US)
    got = s["launched_in"]
    assert got["edst/"] == pytest.approx(10 * US)
    assert got["step/forward/"] == pytest.approx(15 * US)
    assert got["step/backward/"] == pytest.approx(10 * US)
    assert got["step/rows/"] == pytest.approx(5 * US)
    assert got["step/optim"] == pytest.approx(4 * US)
    assert got["fabric/"] == pytest.approx(10 * US)
    assert got["fabric/p2p"] == pytest.approx(8 * US)
    idle = s["idle_in"]
    assert idle["step/forward/"] == pytest.approx(10 * US)   # 0-10
    assert idle["step/backward/"] == pytest.approx(5 * US)   # 25-30
    assert idle["step/rows/"] == pytest.approx(12 * US)      # 40-52
    assert idle["step/optim"] == pytest.approx(11 * US)      # 80-90, 94-95
    assert idle["fabric/"] == pytest.approx(4 * US)          # 55-57, 58-60
    assert idle["fabric/p2p"] == pytest.approx(2 * US)       # 58-60
    # the longest idle gaps are named by the program's spans
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps[:3]] == ["step/rows/v#", "step/optim",
                                        "step/forward/v#"]
    assert [g[1] for g in gaps[:3]] == pytest.approx([20 * US, 12 * US,
                                                      10 * US])


def test_numbers_by_hand_and_consistent():
    s = spans.summarize(span_trace())
    train = spans.numbers("train", s)
    assert train == pytest.approx({"model_ms_per_step.train": 0.025,
                                   "optim_ms_per_step.train": 0.004,
                                   "loop_idle_ms_per_step.train": 0.027})
    sync = spans.numbers("allreduce", s)
    assert sync == pytest.approx({"fabric_ms_per_call.sync": 0.010,
                                  "p2p_ms_per_call.sync": 0.008})
    # the parts against the wholes the accepted metrics read
    compute_ms = 1e3 * (s["launched_s"] - s["launched_in"]["edst/"])
    assert train["model_ms_per_step.train"] \
        + train["optim_ms_per_step.train"] <= compute_ms
    assert sync["p2p_ms_per_call.sync"] <= sync["fabric_ms_per_call.sync"]
    assert train["loop_idle_ms_per_step.train"] <= \
        1e3 * (s["window_s"] - s["busy_s"])


def test_without_the_spans_nothing_is_read():
    """A program that opens none of these spans (one older than them)
    reads none of the five numbers; a stacked fabric reads no
    ``fabric/p2p``."""
    s = spans.summarize(synthetic_trace())
    assert spans.numbers("train", s) == {}
    assert spans.numbers("allreduce", s) == {}
    assert spans.numbers("train", None) == {}
    assert spans.numbers("train", tracecut.summarize(synthetic_trace())) \
        == {}
    stacked = [e for e in span_trace() if e["name"] != "fabric/p2p"]
    assert set(spans.numbers("allreduce", spans.summarize(stacked))) == \
        {"fabric_ms_per_call.sync"}


@pytest.mark.parametrize("trace", [synthetic_trace, span_trace])
def test_tracecut_keys_read_as_before(trace):
    """Every key ``tracecut.summarize`` returns reads the same through
    ``spans.summarize``, on the old synthetic trace and on the new."""
    old = tracecut.summarize(trace())
    new = spans.summarize(trace())
    assert set(new) == set(old) | {"idle_in"}
    for key, value in old.items():
        if key == "launched_in":
            assert new[key]["edst/"] == value["edst/"]
        else:
            assert new[key] == value, key


def test_idle_in_without_a_slice():
    assert spans.idle_in([]) is None
    assert spans.summarize([]) is None


def test_recorded_run_on_the_cpu():
    """A tiny traced training run through :func:`spans.recorded`: the
    kind's summary carries every span prefix, the step's own spans name
    the slice's idle time (no device work on the CPU), and
    ``tracecut.summarize`` is the kinds' own again afterwards."""
    from bench_tiny import TINY_RUNS, run_tiny
    name, config, traffic = TINY_RUNS["train"]
    with spans.recorded() as seen:
        res = run_tiny("train", config, traffic, name, trace=True)
    assert tracecut.summarize is spans._base_summarize
    assert len(seen) == 1 and res["ctx"]["trace"] is seen[0]
    assert set(seen[0]["idle_in"]) == set(spans.PREFIXES)
    assert set(spans.PREFIXES) <= set(seen[0]["launched_in"])
    # 4 vertices' passes: the slice is idle inside each of them
    assert all(seen[0]["idle_in"][p] > 0 for p in spans.LOOP)
    assert seen[0]["idle_in"]["step/optim"] > 0
