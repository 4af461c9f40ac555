#!/usr/bin/env python3
"""Run the port's dry-run cells, one process a cell, several at a time.

    python3 scripts/dryrun_sweep.py [--jobs 3] [--out sweep.json]

Each cell of ``repro_torch.launch.dryrun.iter_cells`` that the reference
does not skip runs as its own ``python -m repro_torch.launch.dryrun
--arch A --shape S [--multi-pod]`` (the fake group is process-wide), one
CPU thread each, ``--jobs`` at a time, on the 16x16 mesh and the
2x16x16 one (at most ``CELL_S`` seconds a cell).  For each cell it
prints and writes its exit code, wall seconds, the CLI's ``trace_s``,
peak bytes a device, dot FLOPs, collective bytes and the process's peak
resident memory, and the torch version beside them; the last lines of a
failed cell's output go into the JSON too.  Exits non-zero if any cell failed.  Host-side reckonings: no
number here is a card's time or memory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("16x16", "2x16x16")
CELL_S = 900


def run_one(arch, shape, mesh, tmp):
    """One cell in its own process: its row of the sweep."""
    out = Path(tmp) / f"{arch}.{shape}.{mesh}.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out)]
    cmd += ["--multi-pod"] if mesh == "2x16x16" else []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    log = Path(tmp) / f"{arch}.{shape}.{mesh}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
        timer = threading.Timer(CELL_S, proc.kill)
        timer.start()
        try:
            _, status, usage = os.wait4(proc.pid, 0)
        finally:
            timer.cancel()
        proc.returncode = os.waitstatus_to_exitcode(status)
    row = {"arch": arch, "shape": shape, "mesh": mesh,
           "rc": proc.returncode,
           "wall_s": round(time.perf_counter() - t0, 1),
           "max_rss_gb": round(usage.ru_maxrss / 1e6, 3)}
    cell = json.loads(out.read_text())[0] if out.is_file() else {}
    if "trace_s" in cell:
        row.update(trace_s=cell["trace_s"],
                   peak_gb=round(cell["memory"]["peak_bytes"] / 1e9, 2),
                   dot_flops=cell["flops"],
                   collective_bytes=cell["collectives"]["total_bytes"])
    if proc.returncode:
        row["tail"] = log.read_text()[-3000:]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch.dryrun import iter_cells

    todo = [(a, s, m) for m in MESHES
            for a, s, skipped in iter_cells() if not skipped]
    print(f"[sweep] torch {torch.__version__}: {len(todo)} cells, "
          f"{args.jobs} at a time", flush=True)
    rows = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(args.jobs) as ex:
        futs = [ex.submit(run_one, a, s, m, tmp) for a, s, m in todo]
        for fut in futs:
            row = fut.result()
            rows.append(row)
            print(f"[sweep] {row['arch']} {row['shape']} {row['mesh']}: "
                  f"rc {row['rc']} wall {row['wall_s']} s trace "
                  f"{row.get('trace_s')} s peak {row.get('peak_gb')} GB "
                  f"flops {row.get('dot_flops')!r} coll "
                  f"{row.get('collective_bytes')!r} rss "
                  f"{row['max_rss_gb']} GB", flush=True)
            if row["rc"]:
                print(row["tail"][-1500:], flush=True)
    failed = [r for r in rows if r["rc"]]
    secs = round(time.perf_counter() - t0, 1)
    print(f"[sweep] {len(rows) - len(failed)}/{len(rows)} cells exit 0 in "
          f"{secs} s", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"torch": torch.__version__, "jobs": args.jobs, "seconds": secs,
             "cells": rows}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
