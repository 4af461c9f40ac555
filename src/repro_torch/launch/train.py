"""End-to-end training entry point of the port: config -> model -> data-parallel
train step (``edst`` or ``psum_dp`` gradient sync over a stacked fabric)
-> deterministic data stream.

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` it raises rather than carry on on the CPU.
``--edst-engine`` picks the compiled allreduce form of ``--sync edst``;
``--profile-dir`` writes a ``torch.profiler`` trace of the loop (Chrome
trace JSON; every step is a ``train/step{i}`` range and every sync wave an
``edst/t*/w*/op`` range), ``--metrics-out`` the metrics registry as JSON.

    python -m repro_torch.launch.train --arch smollm-135m --steps 3 \
        --batch 32 --seq 256 --mesh 4,4,1 --sync edst --quantize-grads
"""
from __future__ import annotations

import argparse
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.steps import ENGINES, make_train_step
from repro_torch.models.transformer import init_lm
from repro_torch.optim import AdamW, cosine_schedule
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
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-grads", action="store_true")
    ap.add_argument("--edst-engine", default="pipelined", choices=ENGINES,
                    help="compiled allreduce form for --sync edst")
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
    """The step function and the data of a training loop."""
    device: torch.device
    step_fn: object
    stream: SyntheticLMStream

    def batch(self, step: int) -> dict:
        return {"tokens": torch.as_tensor(self.stream.batch(step),
                                          dtype=torch.long,
                                          device=self.device)}


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
    step_fn = make_train_step(cfg, opt, dims, names, mode=args.sync,
                              quantize=args.quantize_grads,
                              engine=args.edst_engine)
    stream = SyntheticLMStream(cfg.vocab, args.seq, args.batch,
                               seed=args.seed)
    return Run(device, step_fn, stream), params, opt.init(params)


def profiler(device: torch.device):
    """A ``torch.profiler`` over the host and, on CUDA, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv=None, keep_first_step: bool = False) -> TrainResult:
    """Train; ``keep_first_step`` also returns copies of the parameters
    before and after the first step.  ``step_seconds`` are host-clock
    times from one step's loss being read to the next's."""
    args = parser().parse_args(argv)
    run, params, opt_state = setup(args)
    init = _clone(params) if keep_first_step else None
    steps_total = tmetrics.counter("edst_train_steps_total",
                                   "optimizer steps committed, by sync mode")
    prof = profiler(run.device) if args.profile_dir else nullcontext()
    t0 = last = time.time()
    losses, gnorms, secs, first, metrics = [], [], [], None, {}
    with prof:
        for step in range(args.steps):
            with torch.profiler.record_function(f"train/step{step}"):
                params, opt_state, metrics = run.step_fn(params, opt_state,
                                                         run.batch(step))
                losses.append(float(metrics["loss"]))   # waits for the step
            steps_total.inc(mode=args.sync)
            gnorms.append(float(metrics["grad_norm"]))
            now = time.time()
            secs.append(now - last)
            last = now
            if keep_first_step and step == 0:
                first = _clone(params)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {gnorms[-1]:.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({time.time() - t0:.1f}s)", flush=True)
    trace = None
    if args.profile_dir:
        Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
        trace = str(Path(args.profile_dir) / "trace.json")
        prof.export_chrome_trace(trace)
        print(f"[train] profiler trace -> {trace}")
    if args.metrics_out:
        tmetrics.REGISTRY.dump_json(args.metrics_out)
        print(f"[train] metrics -> {args.metrics_out}")
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return TrainResult(losses, params, metrics, gnorms, secs, init, first,
                       trace)


if __name__ == "__main__":
    main()
