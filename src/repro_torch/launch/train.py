"""End-to-end training entry point of the port: config -> model (through
``models.api.build``: every token family, ``lm``, ``moe``, ``rglru`` and
``rwkv6``) -> data-parallel train step (``edst`` or ``psum_dp`` gradient
sync over a fabric, ``gspmd``'s one whole-batch gradient, or ZeRO-1) ->
deterministic data stream -> checkpoint / restart -> fault loop.

The data stream yields tokens only, so the ``encdec`` and ``vlm``
families (which also need frames or patches) are refused before anything
is built; the reference's trainer fails on them at its first step.
``--sync`` defaults to ``edst`` (the reference's to ``gspmd``).

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` it raises rather than carry on on the CPU.
``--edst-engine`` picks the compiled allreduce form of ``--sync edst``;
``--zero1`` reduce-scatters the gradients, updates owner stripes with the
sharded AdamW and allgathers the params (it forces ``--sync edst
--edst-engine striped``).  ``--ckpt-dir`` resumes from the newest
checkpoint there, saves every ``--ckpt-every`` steps and at the end
(sharded under ``--zero1``).  ``--recover`` closes the fault loop: each
step runs on the fault runtime's active schedule, the fabric is probed,
and the recovery controller retries, flips or rebuilds; a node loss
checkpoints and stops, naming the relaunch onto the survivors through
:mod:`repro_torch.launch.elastic`.  ``--profile-dir`` writes a
``torch.profiler`` trace of the loop (Chrome trace JSON; every step is a ``train/step{i}``
range and every sync wave an ``edst/t*/w*/op`` range; inside a step each
vertex's ``step/forward/v{v}``, ``step/backward/v{v}`` and
``step/rows/v{v}``, then ``step/sync`` and ``step/optim``, and inside a
wave the fabric's ``fabric/zero``, ``fabric/gather`` and ``fabric/p2p``:
:mod:`repro_torch.telemetry.spans`), ``--trace-out``
the predicted Perfetto trace of the compiled sync program
(:mod:`repro_torch.telemetry.trace`), ``--metrics-out`` the metrics
registry as JSON, ``--journal-out`` the recovery journal as JSONL.

    python -m repro_torch.launch.train --arch smollm-135m --steps 3 \
        --batch 32 --seq 256 --mesh 4,4,1 --zero1 --ckpt-dir /tmp/ck

Under ``torchrun`` (``WORLD_SIZE`` set) the run spreads ``--mesh``'s
data-parallel vertices over the ranks, a contiguous block each
(:class:`~repro_torch.dist.fabric.ProcessGroupFabric`): the process group
comes from the environment, NCCL with ``cuda:LOCAL_RANK`` for ``--device
cuda`` and gloo for ``--device cpu``, and rank 0 alone logs and writes
the metrics, traces, the journal and the dense checkpoints.  Under
``--sync gspmd`` the ranks form a ``DeviceMesh`` of ``--mesh``'s shape
with its data axes folded into one (:func:`gspmd_mesh_shape`), every
parameter is a DTensor placed by the reference's logical-axis rules
(:func:`repro_torch.dist.sharding.tree_shardings` with FSDP on:
tensor-parallel over ``model``, ZeRO-3 over the data axes), and the
batch is split over the data axes.  Under
``--zero1`` each rank holds the moments of its own vertices and writes
their shards of the checkpoint (rank 0 the params and the manifest), and
a resume gives each rank its own rows back.  Under ``--recover`` every
rank runs the probe and its own recovery controller on agreed inputs, so
all take each decision at the same step.  ``--trace-out`` is a predicted
trace of the compiled program, written by rank 0.  Under the manual
sync modes (``edst``, ``psum_dp``, ``--zero1``) a world size above the
data extent and a ``model`` axis above 1 are refused before anything is
built.

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --steps 2 --batch 16 --seq 64 --mesh 4,4,1 --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --steps 2 --batch 16 --seq 64 --mesh 2,2 --sync gspmd \
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.ckpt import (latest_step, restore, restore_sharded,
                              save_checkpoint, save_sharded_checkpoint)
from repro_torch.core.collectives import owner_element_map
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.fabric import ProcessGroupFabric
from repro_torch.dist.steps import (ENGINES, dp_extent, edst_spec_for_mesh,
                                    fault_runtime_for_mesh, full_values,
                                    make_train_step)
from repro_torch.models.api import build
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.telemetry import metrics as tmetrics


def parse_mesh(s: str):
    dims = tuple(int(x) for x in s.split(","))
    names = ("pod", "data", "model")[-len(dims):]
    return dims, names


@dataclass
class TrainResult:
    losses: list
    params: dict
    metrics: dict = field(default_factory=dict)   # of the last step
    grad_norms: list = field(default_factory=list)
    step_seconds: list = field(default_factory=list)
    init_params: dict | None = None
    first_step_params: dict | None = None
    profile_trace: str | None = None     # the --profile-dir trace file
    opt_state: object = None             # after the last step
    start_step: int = 0                  # the step a resume began at
    controller: object = None            # --recover: RecoveryController
    monitor: object = None               # --recover: HealthMonitor


def _clone(tree):
    """A copy of a tree of tensors; a DTensor's whole value, gathered on
    every rank."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    return tree.detach().clone()



def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--sync", default="edst",
                    choices=["edst", "psum_dp", "gspmd"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-grads", action="store_true")
    ap.add_argument("--edst-engine", default="pipelined", choices=ENGINES,
                    help="compiled allreduce form for --sync edst")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1: reduce-scatter grads, owner-stripe "
                         "AdamW, allgather params (forces --sync edst "
                         "--edst-engine striped)")
    ap.add_argument("--recover", action="store_true",
                    help="close the fault loop (--sync edst): probe the "
                         "fabric each step, feed step-time and gradient-"
                         "checksum telemetry to the recovery controller, "
                         "and recover in place -- retry on flaps, "
                         "schedule-id flip on link kills, background "
                         "rebuild on bursts; node loss checkpoints and "
                         "stops for a relaunch through "
                         "repro_torch.launch.elastic")
    ap.add_argument("--journal-out", default=None,
                    help="append the recovery journal to this JSONL file "
                         "as transitions happen (--recover)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the training "
                         "loop into DIR (trace.json); the executors' "
                         "edst/t*/w*/op ranges label every sync wave, "
                         "step/forward/v*, step/backward/v*, step/rows/v*, "
                         "step/sync and step/optim the step's parts, and "
                         "fabric/zero, fabric/gather and fabric/p2p the "
                         "fabric's copies and cross-rank sends")
    ap.add_argument("--metrics-out", default=None,
                    help="dump the telemetry metrics registry (JSON) at "
                         "the end of the run")
    ap.add_argument("--trace-out", default=None,
                    help="write a predicted Perfetto trace (Chrome trace "
                         "event JSON) of the compiled sync program at this "
                         "run's gradient payload size before training "
                         "starts (--sync edst; with --recover the whole "
                         "fault-runtime entry table is rendered; on CUDA "
                         "timed by the card's CostModel row)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


@dataclass
class Run:
    """The step function, the data and the fault loop of a training run."""
    args: argparse.Namespace
    device: torch.device
    step_fn: object
    stream: SyntheticLMStream
    remake_step: object = None   # runtime -> step_fn (after a hot swap)
    monitor: object = None
    controller: object = None
    zspec: object = None         # --zero1: the striped spec
    fabric: object = None        # under torchrun: this rank's block
    rank: int = 0                # under torchrun: this process's rank
    owns_group: bool = False     # setup initialised it: main destroys it
    shardings: object = None     # gspmd over ranks: the params' placements

    def batch(self, step: int) -> dict:
        return {"tokens": torch.as_tensor(self.stream.batch(step),
                                          dtype=torch.long,
                                          device=self.device)}

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def save(self, step: int, params, opt_state) -> None:
        if self.zspec is not None:   # each rank its own vertices' shards
            size = sum(p.numel() for p in tree_leaves(params))
            save_sharded_checkpoint(self.args.ckpt_dir, step, params,
                                    opt_state,
                                    owner_element_map(self.zspec, size),
                                    size, fabric=self.fabric)
        else:                        # every rank holds the same state
            state = full_values({"p": params, "o": opt_state})
            if self.rank == 0:
                save_checkpoint(self.args.ckpt_dir, step, state)

    def resume(self, params, opt_state):
        """``(params, opt_state, start step)`` from the newest checkpoint
        in ``--ckpt-dir``, or the given state and 0."""
        ckpt = self.args.ckpt_dir
        if not ckpt or latest_step(ckpt) is None:
            return params, opt_state, 0
        if self.zspec is not None:
            size = sum(p.numel() for p in tree_leaves(params))
            params, opt_state, start, _ = restore_sharded(
                ckpt, params, owner_element_map(self.zspec, size),
                fabric=self.fabric)
        else:
            state, start, _ = restore(
                ckpt, full_values({"p": params, "o": opt_state}))
            params, opt_state = self.place(state["p"], state["o"])
        self.log(f"[train] resumed from step {start}")
        return params, opt_state, start

    def place(self, params, opt_state):
        """Under gspmd over ranks, the params and the moments as DTensors
        placed by :attr:`shardings` (each rank keeps its own shard of the
        whole tensors it holds); otherwise as they are."""
        if self.shardings is None:
            return params, opt_state
        from repro_torch.dist.sharding import distribute
        return (distribute(params, self.shardings),
                type(opt_state)(opt_state.step,
                                distribute(opt_state.mu, self.shardings),
                                distribute(opt_state.nu, self.shardings)))


TOKEN_FAMILIES = ("lm", "moe", "rglru", "rwkv6")


def gspmd_mesh_shape(world: int, dims, names):
    """``(shape, names)`` of the ``DeviceMesh`` a gspmd run over ``world``
    ranks builds for ``--mesh``, or ``None`` where it does not fit.  The
    data axes (``pod``, ``data``) fold into one ``data`` axis, row-major
    as the reference flattens them into a DP rank (a dim split over both
    lies alike), and the ``model`` axis follows it where the two make up
    the world.  A mesh with no ``model`` axis above 1 may also spread
    over any divisor of its data extent: its vertices fold into blocks,
    one ``data`` axis of the world."""
    model = dict(zip(names, dims)).get("model", 1)
    n = dp_extent(dims, names)
    if "model" in names and n * model == world:
        return (n, model), ("data", "model")
    if model == 1 and n % world == 0:
        return (world,), ("data",)
    return None


def dist_setup(args, dims, names):
    """Under ``torchrun`` (``WORLD_SIZE`` set): refuse a mesh that does
    not spread over the ranks, then ``(device, group, rank, initialised
    here)`` with the process group from the environment (or the one
    already initialised).  Without ``WORLD_SIZE``: ``--device`` and no
    group."""
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(args.device), None, 0, False
    world, n = int(os.environ["WORLD_SIZE"]), dp_extent(dims, names)
    model = dict(zip(names, dims)).get("model", 1)
    if args.sync == "gspmd" and not args.zero1:
        if gspmd_mesh_shape(world, dims, names) is None:
            raise SystemExit(
                f"train: WORLD_SIZE {world} does not fit --mesh "
                f"{args.mesh}: gspmd needs the mesh's size, or a divisor "
                f"of its data-parallel extent {n} with no model axis")
    elif model > 1:
        raise SystemExit(f"train: --mesh {args.mesh} has a model axis of "
                         f"{model}; under --sync {args.sync} the ranks hold "
                         "data-parallel vertices only (--sync gspmd runs "
                         "a model axis over the ranks)")
    elif world > n:
        raise SystemExit(f"train: WORLD_SIZE {world} exceeds --mesh "
                         f"{args.mesh}'s data-parallel extent {n}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    mine = not dist.is_initialized()
    if mine:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if dist.get_world_size() != world:
        raise SystemExit(f"train: WORLD_SIZE {world}, but the process "
                         f"group has {dist.get_world_size()} ranks")
    return device, dist.group.WORLD, dist.get_rank(), mine


def setup(args, cfg=None):
    """``(Run, params, opt_state)`` from the parsed arguments; ``cfg``
    replaces ``--arch`` (and ``--reduced``)."""
    if cfg is None:
        cfg = configs.get(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if cfg.family not in TOKEN_FAMILIES:
        raise SystemExit(
            f"train feeds a token stream: {cfg.name} is of the "
            f"{cfg.family} family, whose loss also needs "
            f"{'frames' if cfg.family == 'encdec' else 'patches'} "
            f"(trainable families: {', '.join(TOKEN_FAMILIES)})")
    dims, names = parse_mesh(args.mesh)
    device, group, rank, mine = dist_setup(args, dims, names)
    api = build(cfg)
    opt = AdamW(cosine_schedule(args.lr, args.warmup, args.steps))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, device)
    n = dp_extent(dims, names)
    run = Run(args, device, None, SyntheticLMStream(
        cfg.vocab, args.seq, args.batch, seed=args.seed), rank=rank,
        owns_group=mine)
    if group is not None and n > 1 and args.sync != "gspmd":
        run.fabric = ProcessGroupFabric(n, device, group)
    if args.zero1:
        run.zspec = edst_spec_for_mesh(dims, names, engine="striped")
        opt_state = ShardedAdamW(opt).init_for(params, run.zspec, n,
                                               fabric=run.fabric)
    elif group is not None and args.sync == "gspmd":
        # the reference's train.py: every parameter placed by the
        # logical-axis rules, FSDP on
        from repro_torch.dist.sharding import tree_shardings
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(*gspmd_mesh_shape(dist.get_world_size(), dims,
                                           names))
        run.shardings = tree_shardings(api.param_axes(), params, mesh,
                                       fsdp=True)
        params, opt_state = run.place(params, opt.init(params))
    else:
        opt_state = opt.init(params)
    runtime = None
    if args.recover and n > 1:
        from repro_torch.dist.health import HealthMonitor
        from repro_torch.dist.recovery import RecoveryController
        runtime = fault_runtime_for_mesh(dims, names,
                                         engine=args.edst_engine)
        run.monitor = HealthMonitor(run.fabric or device, runtime)
        # rank 0 alone writes the journal; every rank keeps it in memory
        run.controller = RecoveryController(
            runtime, journal_path=args.journal_out if rank == 0 else None,
            clock=run.monitor.clock, agree=run.monitor.fabric.all_true)

    def remake_step(rt):
        return make_train_step(api, opt, dims, names, mode=args.sync,
                               quantize=args.quantize_grads,
                               engine=args.edst_engine, zero1=args.zero1,
                               fault_runtime=rt, telemetry=rt is not None,
                               group=group)

    run.remake_step = remake_step
    run.step_fn = remake_step(runtime)
    return run, params, opt_state


# the cuda row's predicted time of the 4x4 torus's full-width pipelined
# program over the measured sum of its 12 waves (0.0968 s against 0.2241 s
# on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's phase_telemetry)
CUDA_ROW_SHARE = 0.43


def write_sync_trace(args, run: Run, params) -> None:
    """``--trace-out``: the predicted Perfetto trace of the compiled sync
    program at this run's gradient payload (4 bytes a parameter): the
    fault runtime's entry table under ``--recover``, the striped spec
    under ``--zero1``, else the ``--edst-engine`` spec.  On CUDA the
    spans are timed by ``CostModel.for_backend("cuda")`` (and the printout
    says how far that row falls short of the card); on the CPU by the
    default constants, as in the reference."""
    from repro_torch.core.collectives import CostModel
    from repro_torch.telemetry import trace as ttrace
    dims, names = parse_mesh(args.mesh)
    if args.sync != "edst" or dp_extent(dims, names) < 2:
        print("[train] --trace-out skipped: no compiled EDST sync "
              "program on this mesh/sync mode")
        return
    nbytes = 4 * sum(p.numel() for p in tree_leaves(params))
    cm = CostModel.for_backend("cuda") if run.device.type == "cuda" \
        else None
    consts = cm or CostModel()
    print(f"[train] sync trace timed by the "
          f"{'cuda' if cm else 'default'} CostModel: alpha "
          f"{consts.alpha!r} s, link_bw {consts.link_bw!r} B/s")
    if cm is not None:
        print(f"[train] the spans are the cuda row's predictions, not the "
              f"card's times: one alpha and link_bw over every wave "
              f"predicts the 4x4 torus's full-width pipelined allreduce at "
              f"{CUDA_ROW_SHARE:.0%} of its time measured on an H100")
    if run.controller is not None:
        tr = ttrace.trace_runtime(run.controller.runtime, nbytes=nbytes,
                                  cost_model=cm)
    else:
        spec = run.zspec if run.zspec is not None else \
            edst_spec_for_mesh(dims, names, engine=args.edst_engine)
        tr = ttrace.trace_spec(spec, nbytes=nbytes, cost_model=cm,
                               label=f"edst/{args.edst_engine}")
    ttrace.write_trace(args.trace_out, tr)
    print(f"[train] predicted sync trace -> {args.trace_out}")


def profiler(device: torch.device):
    """A ``torch.profiler`` over the host and, on CUDA, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _recover_tick(run: Run, step: int, t1: float, metrics):
    """Feed one step's probe and telemetry to the recovery controller.
    Returns ``None`` to commit the step, ``"redo"`` to discard it and run
    it again after recovery, or ``"stop"`` on a node loss.  Over ranks
    the monitor agrees the probe, the step time and the clock, and the
    controller the adoption of a rebuild, so every rank returns the
    same."""
    from repro_torch.dist.health import HealthMonitor
    ctrl = run.controller
    report = run.monitor.check(
        step, step_time=time.time() - t1,
        checksum_dev=float(metrics.get("sync_dev", 0.0)))
    dec = ctrl.observe(report)
    if dec.action == "rescale" and ctrl.state == "stalled":
        # a lost vertex needs a NEW fabric: checkpoint and hand off to
        # repro_torch.launch.elastic on the survivors
        from repro_torch.launch.elastic import survivor_mesh
        nodes = dec.detail.get("nodes") or ()
        mesh = ",".join(map(str, survivor_mesh(
            ctrl.runtime.graph.n - len(nodes))))
        ck = run.args.ckpt_dir or "DIR"
        run.log(f"[train] node loss at step {step} ({list(nodes)}); "
                + ("checkpoint saved" if run.args.ckpt_dir
                   else "no --ckpt-dir, nothing saved")
                + " -- relaunch on the surviving vertices: python -m "
                f"repro_torch.launch.elastic --ckpt-dir {ck} --to-mesh "
                f"{mesh}, then python -m repro_torch.launch.train --mesh "
                f"{mesh} --ckpt-dir {ck}")
        return "stop"
    if dec.action == "none":
        return None
    # the step ran over suspect fabric: discard it and redo it after
    # recovery (flip / hot swap / backoff)
    run.log(f"[train] step {step}: {dec.action} (schedule "
            f"{dec.schedule_id}) {dec.detail}")
    if dec.runtime_changed:
        run.step_fn = run.remake_step(ctrl.runtime)
        run.monitor = HealthMonitor(run.monitor.fabric, ctrl.runtime,
                                    straggler=run.monitor.straggler)
    if dec.backoff_s:
        time.sleep(dec.backoff_s)
    return "redo"


def main(argv=None, keep_first_step: bool = False,
         cfg=None) -> TrainResult:
    """Train; ``keep_first_step`` also returns copies of the parameters
    before and after the first step this run takes; ``cfg`` (from Python
    only, e.g. a depth-cut config) replaces ``--arch``.  ``step_seconds``
    are host-clock times from one step's loss being read to the next's."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.zero1:
        args.sync, args.edst_engine = "edst", "striped"
    if args.recover and (args.sync != "edst" or args.zero1):
        ap.error("--recover requires --sync edst without --zero1 (the "
                 "reference runs the zero1 recovery loop in its "
                 "benchmarks/chaos_soak.py, which the port does not "
                 "carry)")
    run, params, opt_state = setup(args, cfg)
    try:
        if args.trace_out and run.rank == 0:
            write_sync_trace(args, run, params)
        params, opt_state, start = run.resume(params, opt_state)
        ctrl = run.controller
        init = _clone(params) if keep_first_step else None
        steps_total = tmetrics.counter(
            "edst_train_steps_total",
            "optimizer steps committed, by sync mode")
        prof = profiler(run.device) if args.profile_dir else nullcontext()
        t0 = last = time.time()
        losses, gnorms, secs, first, metrics = [], [], [], None, {}
        step = saved = start
        with prof:
            while step < args.steps:
                batch = run.batch(step)
                snapshot = (params, opt_state)
                t1 = time.time()
                with torch.profiler.record_function(f"train/step{step}"):
                    if ctrl is not None:
                        params, opt_state, metrics = run.step_fn(
                            params, opt_state, batch, ctrl.schedule_id)
                    else:
                        params, opt_state, metrics = run.step_fn(
                            params, opt_state, batch)
                    loss = float(metrics["loss"])   # waits for the step
                if ctrl is not None:
                    verdict = _recover_tick(run, step, t1, metrics)
                    if verdict is not None:
                        # the step's new tensors are dropped; the snapshot's
                        # were never written to
                        params, opt_state = snapshot
                        if verdict == "stop":
                            break
                        continue
                losses.append(loss)
                steps_total.inc(mode=args.sync)
                gnorms.append(float(metrics["grad_norm"]))
                now = time.time()
                secs.append(now - last)
                last = now
                if keep_first_step and first is None:
                    first = _clone(params)
                if step % args.log_every == 0 or step == args.steps - 1:
                    run.log(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                            f"gnorm {gnorms[-1]:.3f} "
                            f"lr {float(metrics['lr']):.2e} "
                            f"({time.time() - t0:.1f}s)")
                step += 1
                if args.ckpt_dir and step % args.ckpt_every == 0:
                    run.save(step, params, opt_state)
                    saved = step
        trace = None
        if args.profile_dir and run.rank == 0:
            Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
            trace = str(Path(args.profile_dir) / "trace.json")
            prof.export_chrome_trace(trace)
            print(f"[train] profiler trace -> {trace}")
        if args.metrics_out and run.rank == 0:
            tmetrics.REGISTRY.dump_json(args.metrics_out)
            print(f"[train] metrics -> {args.metrics_out}")
        if ctrl is not None and ctrl.journal:
            run.log(f"[train] recovery journal ({len(ctrl.journal)} "
                    "entries):")
            for row in ctrl.journal_rows():
                run.log(f"[train]   {json.dumps(row)}")
        if args.ckpt_dir and saved != step:
            run.save(step, params, opt_state)
        if losses:
            run.log(f"[train] done: first loss {losses[0]:.4f} -> last "
                    f"{losses[-1]:.4f}")
        return TrainResult(losses, full_values(params), metrics, gnorms,
                           secs, init, first, trace, full_values(opt_state),
                           start, ctrl, run.monitor)
    finally:
        if run.owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
