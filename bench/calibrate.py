"""Read the numbers a cell's correctness check compares, on many seeds,
to set its limits: the program's (sound runs), the control's (the plain
reference one precision step down, in the program's place) and each
fault's, planted in the reference put in the program's place.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 3] [--out FILE]

Runs on the card, at the cell's own sizes, in one process (with its
ranks, where the cell spans cards): for every seed the program's first
steps or one call and the reference; for the first ``--control`` seeds
also the control and the faults.  Prints one JSON line a reading and
appends it to ``--out``.

Training cells: the control is the reference with every matrix product's
operands in float8 e4m3; the faults are half the batch left out (the
mean over the other half) and the exchange left out (each vertex keeps
its own gradient).  A state left unchanged reads 1 in ``move_leaf_gap``
and needs no run.  Allreduce cells: the control sums the rows in
bfloat16; the faults are the rows returned unchanged, half the rows left
out (the sum of the rest doubled), the exchange between cards left out
(each card's sum of its own four rows) and one answer altered where it
is produced (an element of one output row off by one).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402


def emit(out, row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_cell(name, config, traffic, seeds, control, out, device="cuda"):
    import torch
    from kinds import train as T
    dev = torch.device(device)
    # one step object for every seed: the step is functional, so the
    # zeroed optimizer state it was built with starts each seed afresh
    run_, zeros, shapes, n = T.build(config, traffic, dev)
    for k, seed in enumerate(seeds):
        t = time.perf_counter()
        params, opt_state, prog, first, moved, _ = T.first_steps(
            run_.step_fn, zeros, shapes, seed, dev, config, traffic, n)
        del params, opt_state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        tp = time.perf_counter() - t
        t = time.perf_counter()
        steps = traffic["ref_steps"]
        ref = T.reference_readings(config, traffic, shapes, seed, dev, n,
                                   steps)
        tr = time.perf_counter() - t
        emit(out, {"workload": name, "seed": seed, "side": "program",
                   **dict(T.gaps(prog, first, moved, ref, leaves=True)),
                   "program_s": tp, "reference_s": tr,
                   "loss": prog["loss"], "ref_loss": ref["loss"],
                   "grad_norm": prog["grad_norm"],
                   "ref_grad_norm": ref["grad_norm"]})
        if k >= control:
            continue
        sides = {"control": {"precision": "fp8"},
                 "fault_half": {"vertices": list(range(n // 2))},
                 "fault_exchange": {"exchange": False}}
        for side, kw in sides.items():
            c = T.reference_readings(config, traffic, shapes, seed, dev, n,
                                     steps, **kw)
            # the routing compared is the control's (a fault routes as the
            # reference does, and half the batch routes half the tokens)
            routes = c["routes"] if side == "control" else None
            emit(out, {"workload": name, "seed": seed, "side": side,
                       **dict(T.gaps({"loss": c["loss"],
                                      "grad_norm": c["grad_norm"],
                                      "routes": routes},
                                     c["first_grad"], c["moved"], ref,
                                     leaves=True))})
        emit(out, {"workload": name, "seed": seed, "side": "fault_unchanged",
                   "move_leaf_gap": 1.0})


def allreduce_rank(rank, world, init, name, config, traffic, seeds, control,
                   out, device="cuda"):
    import datetime

    import torch
    import torch.distributed as dist
    from kinds import allreduce as A
    from reference.allreduce import max_rel_err, row_sum

    import weights
    harness.program_path()
    from repro_torch.dist.fabric import ProcessGroupFabric, StackedFabric
    from repro_torch.dist.steps import edst_spec_for_mesh
    from repro_torch.dist.tree_allreduce import tree_allreduce
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if world > 1:
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=240), **kw)
    mesh = tuple(traffic["mesh"])
    spec = edst_spec_for_mesh(mesh, ("pod", "data", "model")[-len(mesh):],
                              engine=traffic["engine"])
    n, width = spec.n, A.payload_width(config)
    fabric = StackedFabric(n, dev) if world == 1 \
        else ProcessGroupFabric(n, dev)
    x = torch.empty((fabric.rows, width), dtype=torch.float32, device=dev)
    for k, seed in enumerate(seeds):
        for j, v in enumerate(range(fabric.lo, fabric.hi)):
            weights.payload_row(seed, v, width, dev, out=x[j])
        y = tree_allreduce(x, spec, fabric, segments=traffic["segments"])
        ref = A.reference_sum(seed, n, width, dev)
        err = torch.tensor([max_rel_err(y, ref)], device=dev,
                           dtype=torch.float64)
        if world > 1:
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
        if rank == 0:
            emit(out, {"workload": name, "seed": seed, "side": "program",
                       "max_rel_err": float(err)})
        if rank == 0 and k < control:
            def fill(v, buf):
                weights.payload_row(seed, v, width, dev, out=buf)
            faults = {
                "control": row_sum(fill, n, width, dev, torch.bfloat16),
                "fault_half": 2 * row_sum(fill, n // 2, width, dev),
                "fault_exchange": row_sum(fill, 4, width, dev),
                "fault_unchanged": x[0]}
            alt = y[0].clone()
            alt[weights.sub_seed(seed, "alter") % width] += 1.0
            faults["fault_altered"] = alt
            for side, rows in faults.items():
                emit(out, {"workload": name, "seed": seed, "side": side,
                           "max_rel_err": max_rel_err(rows[None], ref)})
            del faults, alt
        del y, ref
    if world > 1:
        dist.destroy_process_group()


def allreduce_cell(name, config, traffic, seeds, control, out,
                   device="cuda"):
    world = traffic["ranks"]
    if world == 1:
        return allreduce_rank(0, 1, None, name, config, traffic, seeds,
                              control, out, device)
    import torch.multiprocessing as mp
    from kinds.allreduce import _free_port
    ctx = mp.get_context("spawn")
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=allreduce_rank,
                         args=(r, world, init, name, config, traffic, seeds,
                               control, None, device))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        allreduce_rank(0, world, init, name, config, traffic, seeds, control,
                       out, device)
    finally:
        for p in procs:
            p.join(600)
            if p.is_alive():
                p.kill()
                p.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell, config, traffic = harness.find_cell(bench, args.workload)
    harness.program_path()
    harness.load_kind(traffic["kind"])
    seeds = [int(s) for s in args.seeds.split(",")]
    if traffic["kind"] == "train":
        train_cell(args.workload, config, traffic, seeds, args.control,
                   args.out)
    else:
        allreduce_cell(args.workload, config, traffic, seeds, args.control,
                       args.out)
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
