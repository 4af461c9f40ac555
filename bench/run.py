"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: finds the cell in ``BENCHMARK.json``, its
configuration, traffic and metric readers under ``bench/`` by name, runs
the traffic's kind (set-up, warm-up, the measured window, the check
against the plain reference) on as many cards as the cell asks for, and
prints each compared number beside its limit on standard error and one
JSON object as the last line of standard output.  ``--trace 1`` adds a
profiled slice after the window and reports the per-layer metrics.

Exits non-zero, printing no result, without enough CUDA cards, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def report(bench: dict, workload: str, trace: bool, res: dict) -> int:
    """Print the result of the printing rank: the checks on standard
    error, the result line last on standard output."""
    bad = sorted(set(harness.forbidden_modules()) | set(res["forbidden"]))
    if bad:
        print(f"bench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    metrics = harness.read_metrics(
        harness.metrics_for(bench, workload, trace), res["ctx"])
    for line in harness.check_lines(res["checks"]):
        print(line, file=sys.stderr)
    print(harness.result_line(
        res["correct"], res["attempted"], res["failed"], metrics,
        res["device"], res["checks"],
        res["breakdown"] if trace else None), flush=True)
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    bench = harness.load_benchmark()
    cell, config, traffic = harness.find_cell(bench, args.workload)
    harness.program_path()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    kind = harness.load_kind(traffic["kind"])
    res = kind.run(cell, config, traffic, harness.limits_for(args.workload),
                   args.seed, args.seconds, bool(args.trace), T0)
    return report(bench, args.workload, bool(args.trace), res)


if __name__ == "__main__":
    sys.exit(main())
