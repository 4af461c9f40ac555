"""End-to-end training entry point of the port: config -> model ->
data-parallel train step (``edst`` or ``psum_dp`` gradient sync over a
stacked fabric, or ZeRO-1) -> deterministic data stream -> checkpoint /
restart -> fault loop.

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
range and every sync wave an ``edst/t*/w*/op`` range), ``--metrics-out``
the metrics registry as JSON, ``--journal-out`` the recovery journal as
JSONL.

    python -m repro_torch.launch.train --arch smollm-135m --steps 3 \
        --batch 32 --seq 256 --mesh 4,4,1 --zero1 --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import json
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.ckpt import (latest_step, restore, restore_sharded,
                              save_checkpoint, save_sharded_checkpoint)
from repro_torch.core.collectives import owner_element_map
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.steps import (ENGINES, dp_extent, edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.models.transformer import init_lm
from repro_torch.optim import AdamW, ShardedAdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.telemetry import metrics as tmetrics


def parse_mesh(s: str):
    dims = tuple(int(x) for x in s.split(","))
    names = ("pod", "data", "model")[-len(dims):]
    return dims, names


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return dev


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
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1,1")
    ap.add_argument("--sync", default="edst", choices=["edst", "psum_dp"])
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
                         "edst/t*/w*/op ranges label every sync wave")
    ap.add_argument("--metrics-out", default=None,
                    help="dump the telemetry metrics registry (JSON) at "
                         "the end of the run")
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

    def batch(self, step: int) -> dict:
        return {"tokens": torch.as_tensor(self.stream.batch(step),
                                          dtype=torch.long,
                                          device=self.device)}

    def save(self, step: int, params, opt_state) -> None:
        if self.zspec is not None:
            size = sum(p.numel() for p in tree_leaves(params))
            save_sharded_checkpoint(self.args.ckpt_dir, step, params,
                                    opt_state,
                                    owner_element_map(self.zspec, size),
                                    size)
        else:
            save_checkpoint(self.args.ckpt_dir, step,
                            {"p": params, "o": opt_state})

    def resume(self, params, opt_state):
        """``(params, opt_state, start step)`` from the newest checkpoint
        in ``--ckpt-dir``, or the given state and 0."""
        ckpt = self.args.ckpt_dir
        if not ckpt or latest_step(ckpt) is None:
            return params, opt_state, 0
        if self.zspec is not None:
            size = sum(p.numel() for p in tree_leaves(params))
            params, opt_state, start, _ = restore_sharded(
                ckpt, params, owner_element_map(self.zspec, size))
        else:
            state, start, _ = restore(ckpt, {"p": params, "o": opt_state})
            params, opt_state = state["p"], state["o"]
        print(f"[train] resumed from step {start}")
        return params, opt_state, start


def setup(args):
    """``(Run, params, opt_state)`` from the parsed arguments."""
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dims, names = parse_mesh(args.mesh)
    opt = AdamW(cosine_schedule(args.lr, args.warmup, args.steps))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm(cfg, gen, device)
    n = dp_extent(dims, names)
    run = Run(args, device, None, SyntheticLMStream(
        cfg.vocab, args.seq, args.batch, seed=args.seed))
    if args.zero1:
        run.zspec = edst_spec_for_mesh(dims, names, engine="striped")
        opt_state = ShardedAdamW(opt).init_for(params, run.zspec, n)
    else:
        opt_state = opt.init(params)
    runtime = None
    if args.recover and n > 1:
        from repro_torch.dist.health import HealthMonitor
        from repro_torch.dist.recovery import RecoveryController
        runtime = fault_runtime_for_mesh(dims, names,
                                         engine=args.edst_engine)
        run.monitor = HealthMonitor(device, runtime)
        run.controller = RecoveryController(runtime,
                                            journal_path=args.journal_out)

    def remake_step(rt):
        return make_train_step(cfg, opt, dims, names, mode=args.sync,
                               quantize=args.quantize_grads,
                               engine=args.edst_engine, zero1=args.zero1,
                               fault_runtime=rt, telemetry=rt is not None)

    run.remake_step = remake_step
    run.step_fn = remake_step(runtime)
    return run, params, opt_state


def profiler(device: torch.device):
    """A ``torch.profiler`` over the host and, on CUDA, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _recover_tick(run: Run, step: int, t1: float, metrics):
    """Feed one step's probe and telemetry to the recovery controller.
    Returns ``None`` to commit the step, ``"redo"`` to discard it and run
    it again after recovery, or ``"stop"`` on a node loss."""
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
        print(f"[train] node loss at step {step} ({list(nodes)}); "
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
    print(f"[train] step {step}: {dec.action} (schedule {dec.schedule_id}) "
          f"{dec.detail}")
    if dec.runtime_changed:
        run.step_fn = run.remake_step(ctrl.runtime)
        run.monitor = HealthMonitor(run.device, ctrl.runtime,
                                    straggler=run.monitor.straggler)
    if dec.backoff_s:
        time.sleep(dec.backoff_s)
    return "redo"


def main(argv=None, keep_first_step: bool = False) -> TrainResult:
    """Train; ``keep_first_step`` also returns copies of the parameters
    before and after the first step this run takes.  ``step_seconds`` are
    host-clock times from one step's loss being read to the next's."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.zero1:
        args.sync, args.edst_engine = "edst", "striped"
    if args.recover and (args.sync != "edst" or args.zero1):
        ap.error("--recover requires --sync edst without --zero1 (the "
                 "reference runs the zero1 recovery loop in its "
                 "benchmarks/chaos_soak.py, which the port does not "
                 "carry)")
    if args.recover and args.quantize_grads and args.edst_engine == "striped":
        ap.error("--recover refuses --quantize-grads with --edst-engine "
                 "striped: that engine's int8 allgather re-codes every hop, "
                 "so its vertex rows differ by design and the controller "
                 "would read every step's checksum spread as corruption")
    run, params, opt_state = setup(args)
    params, opt_state, start = run.resume(params, opt_state)
    ctrl = run.controller
    init = _clone(params) if keep_first_step else None
    steps_total = tmetrics.counter("edst_train_steps_total",
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
                print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {gnorms[-1]:.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            step += 1
            if args.ckpt_dir and step % args.ckpt_every == 0:
                run.save(step, params, opt_state)
                saved = step
    trace = None
    if args.profile_dir:
        Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
        trace = str(Path(args.profile_dir) / "trace.json")
        prof.export_chrome_trace(trace)
        print(f"[train] profiler trace -> {trace}")
    if args.metrics_out:
        tmetrics.REGISTRY.dump_json(args.metrics_out)
        print(f"[train] metrics -> {args.metrics_out}")
    if ctrl is not None and ctrl.journal:
        print(f"[train] recovery journal ({len(ctrl.journal)} entries):")
        for row in ctrl.journal_rows():
            print(f"[train]   {json.dumps(row)}")
    if args.ckpt_dir and saved != step:
        run.save(step, params, opt_state)
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return TrainResult(losses, params, metrics, gnorms, secs, init, first,
                       trace, opt_state, start, ctrl, run.monitor)


if __name__ == "__main__":
    main()
