"""The ``train`` traffic kind: data-parallel training steps of a decoder
LM through the program's own training entry point.

Set-up builds the step the way ``repro_torch.launch.train`` does
(``setup``: ``make_train_step`` in the traffic's sync mode and engine),
swaps the program's own initial weights for the benchmark's (drawn from
the seed in the program's layout) and drives that one step object
through the traffic's ``warm_steps`` first steps: they warm every shape,
and the plain reference follows them.  The window then runs steps back
to back, each on a batch of its own drawn from the seed, reading each
step's loss as the program's loop does, until ``--seconds`` have passed.
With ``--trace 1`` a profiler then records ``trace_steps`` more steps.

After the window the program's state is freed and the reference repeats
the first steps from the same weights and batches, in f32 with TF32 off.
The numbers compared (each against the cell's limit):

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_norm_gap``: the relative gap of the first step's global
  gradient norm (before clipping);
* ``grad_leaf_gap``: the first gradient as the optimizer got it (its
  first moment after one step, over 1 - b1), by the worst leaf: the gap
  between the two norms of a leaf, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``move_leaf_gap``: the same of each leaf's change over the first
  steps, read before the window's first step; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out;
* ``route_mismatch`` (routed-expert models): the share of the first
  step's (token, choice) pairs whose expert the program's router chose
  and the reference's did not.

A cell compares those its limits file names.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from contextlib import contextmanager, nullcontext

import counts
import harness
import modelcfg
import tracecut
import weights


def _norms(tree, minus=None) -> dict:
    import torch
    out = {}
    other = dict(weights.leaves(minus)) if minus is not None else {}
    for path, t in weights.leaves(tree):
        x = t.detach()
        if path in other:
            x = x - other[path]
        out[path] = float(torch.linalg.vector_norm(x.double()))
    return out


def leaf_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """Each leaf's gap between two sets of leaf norms, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med)
            for k in ref if k not in skip}


class RouteLog:
    """The experts the program's router chose, recorded from its
    ``route`` while :meth:`recording` runs (one ``(tokens, k)`` tensor a
    call)."""

    def __init__(self):
        self.calls = []

    @contextmanager
    def recording(self, module):
        real = module.route

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            idx = out[3]
            self.calls.append(idx.reshape(-1, idx.shape[-1]).detach())
            return out

        module.route = wrapped
        try:
            yield self
        finally:
            module.route = real

    def forward_routes(self, n_vertices: int, n_layers: int) -> list:
        """Each vertex's forward routing, a layer at a time: a vertex's
        first ``n_layers`` calls (a checkpointed layer routes again in
        the backward)."""
        per = len(self.calls) // n_vertices
        return [c for v in range(n_vertices)
                for c in self.calls[v * per:v * per + n_layers]]


def route_mismatch(prog: list, ref: list) -> float:
    """The share of (token, choice) pairs whose expert the program chose
    and the reference did not, over the first step's forward."""
    import torch
    missed = total = 0
    for a, b in zip(prog, ref, strict=True):
        b = b.to(a.device)
        e = int(max(a.max(), b.max())) + 1
        ha = torch.nn.functional.one_hot(a.long(), e).sum(-2)
        hb = torch.nn.functional.one_hot(b.long(), e).sum(-2)
        total += a.numel()
        missed += a.numel() - int((ha.clamp(max=1) * hb.clamp(max=1)).sum())
    return missed / total


def _opt_check(opt: dict) -> None:
    from repro_torch.optim import AdamW
    want = {f: getattr(AdamW, f) for f in
            ("b1", "b2", "eps", "weight_decay", "clip_norm")}
    bad = {f: v for f, v in want.items() if opt[f] != v}
    if bad:
        raise SystemExit(f"bench: the program's AdamW runs {bad}, not the "
                         "traffic's optimizer settings")


def build(config: dict, traffic: dict, device):
    """The program's step object, set up as its training entry point sets
    it up: ``(run, zeroed optimizer state, parameter shapes)``."""
    from repro_torch.launch import train as T
    cfg = modelcfg.port_config(config)
    mesh = traffic["mesh"]
    opt = traffic["optimizer"]
    _opt_check(opt)
    n = math.prod(mesh[:-1]) if len(mesh) == 3 else math.prod(mesh)
    argv = ["--batch", str(n * traffic["batch_per_vertex"]),
            "--seq", str(traffic["seq"]),
            "--mesh", ",".join(map(str, mesh)), "--sync", traffic["sync"],
            "--edst-engine", traffic["engine"],
            "--steps", str(opt["total_steps"]), "--lr", str(opt["lr"]),
            "--warmup", str(opt["warmup"]), "--seed", "0",
            "--device", str(device)]
    args = T.parser().parse_args(argv)
    run, params, opt_state = T.setup(args, cfg)
    shapes = weights.shapes_of(params)
    del params
    return run, opt_state, shapes, n


def first_steps(step_fn, opt_state, shapes, seed, dev, config, traffic, n,
                t0=None):
    """Drive the step object through the traffic's ``warm_steps`` first
    steps from the benchmark's weights.  Returns the parameters and the
    optimizer state after them, the program's readings (each step's loss
    and global gradient norm; the first gradient's leaf norms, read from
    the first moment; each leaf's change over the reference's steps, read
    before the next step) and the combine's bytes over the second step."""
    from repro_torch.dist import tree_allreduce as tc_engine
    from repro_torch.kernels.tree_combine import kernel as tc_kernel
    from repro_torch.models import moe as moe_mod
    bsz, seq = n * traffic["batch_per_vertex"], traffic["seq"]
    b1 = traffic["optimizer"]["b1"]
    warm, ref_steps = traffic["warm_steps"], traffic["ref_steps"]
    if not 2 <= ref_steps <= warm:
        raise SystemExit("bench: the reference follows 2 to warm_steps steps")
    params = weights.make_params(shapes, seed, dev)
    prog = {"loss": [], "grad_norm": []}
    combine, routes = counts.KernelBytes(), RouteLog()
    target = (tc_kernel, "tree_combine") if dev.type == "cuda" \
        else (tc_engine, "combine")
    first = moved = None
    for i in range(warm):
        batch = {"tokens": weights.tokens(seed, i, bsz, seq,
                                          config["vocab_size"], dev)}
        # the first step records the router's choices, the second the
        # combine's bytes
        if i == 0 and config.get("num_experts"):
            rec = routes.recording(moe_mod)
        elif i == 1:
            rec = combine.recording(*target)
        else:
            rec = nullcontext()
        with rec:
            params, opt_state, m = step_fn(params, opt_state, batch)
            prog["loss"].append(float(m["loss"]))
        prog["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            first = {k: v / (1 - b1) for k, v in _norms(opt_state.mu).items()}
        if i == ref_steps - 1:   # before the next step writes over them
            p0 = weights.make_params(shapes, seed, dev)
            moved = _norms(params, minus=p0)
            del p0
        if t0 is not None:
            harness.log(t0, f"warm step {i}: loss {prog['loss'][-1]!r}")
    if routes.calls:
        prog["routes"] = routes.forward_routes(
            n, config["num_hidden_layers"])
    return params, opt_state, prog, first, moved, combine


def run(cell, config, traffic, limits, seed, seconds, trace, t0,
        device="cuda", plant=None):
    """One run of a training cell; returns the result the harness
    prints.  ``plant`` (tests only) wraps the step function."""
    import torch
    dev = torch.device(device)
    torch.set_num_threads(2)
    harness.log(t0, "program imported; building the step")
    run_, opt_state, shapes, n = build(config, traffic, dev)
    harness.log(t0, f"step built ({n} vertices)")
    step_fn = run_.step_fn if plant is None else plant(run_.step_fn)
    bsz, seq = n * traffic["batch_per_vertex"], traffic["seq"]

    def batch(i):
        return {"tokens": weights.tokens(seed, i, bsz, seq,
                                         config["vocab_size"], dev)}

    harness.log(t0, "making the weights; warm steps")
    params, opt_state, prog, first, moved, combine = first_steps(
        step_fn, opt_state, shapes, seed, dev, config, traffic, n, t0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    # the window
    steps, i, nonfinite = 0, traffic["warm_steps"], 0
    start = time.perf_counter()
    while True:
        params, opt_state, m = step_fn(params, opt_state, batch(i))
        loss = float(m["loss"])
        nonfinite += not math.isfinite(loss)
        steps, i = steps + 1, i + 1
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    harness.log(t0, f"window: {steps} steps in {window_s!r} s")

    summary = None
    if trace:
        with tracecut.profiled(dev.type) as prof:
            with torch.profiler.record_function(tracecut.SLICE):
                for _ in range(traffic["trace_steps"]):
                    with torch.profiler.record_function(
                            f"{tracecut.UNIT}{i}"):
                        params, opt_state, m = step_fn(params, opt_state,
                                                       batch(i))
                        float(m["loss"])
                    i += 1
        summary = tracecut.summarize(tracecut.events_of(prof))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, opt_state, m, step_fn, run_
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    harness.log(t0, f"peak {peak} bytes; the reference follows "
                    f"{traffic['ref_steps']} steps")
    checks = compare(config, traffic, shapes, seed, dev, n, prog, first,
                     moved, limits, t0)
    harness.log(t0, "reference done")
    ctx = {"kind": "train", "setup_s": setup_s,
           "window": {"seconds": window_s, "count": steps,
                      "tokens": steps * bsz * seq},
           "trace": summary, "world": 1,
           "counts": {"flops_per_token":
                      counts.model_flops_per_token(config, seq),
                      "combine_bytes_per_unit": combine.bytes}}
    device_info = harness.device_record(dev, 1, peak, summary)
    return {"correct": harness.within(checks) and not nonfinite,
            "attempted": steps, "failed": nonfinite, "checks": checks,
            "ctx": ctx, "device": device_info,
            "breakdown": summary["breakdown"] if summary else None,
            "forbidden": []}


def reference_readings(config, traffic, shapes, seed, dev, n, steps,
                       precision="f32", vertices=None, exchange=True):
    """The reference's readings of the first ``steps`` steps."""
    import importlib

    import torch
    decoder = importlib.import_module(f"reference.{config['reference']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bsz, seq = n * traffic["batch_per_vertex"], traffic["seq"]
    w = weights.make_params(shapes, seed, dev)
    out = decoder.train_steps(
        config, w, lambda t: weights.tokens(seed, t, bsz, seq,
                                            config["vocab_size"], dev),
        n, steps, traffic["optimizer"], traffic["ref_block"], precision,
        vertices=vertices, exchange=exchange)
    p0 = weights.make_params(shapes, seed, dev)
    out["moved"] = _norms(w, minus=p0)
    del w, p0
    return out


def gaps(prog, first, moved, ref, leaves=False) -> list:
    """``[(name, value)]`` of the numbers compared, each leaf's gaps too
    with ``leaves``."""
    steps = len(ref["loss"])
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["loss"][:steps], ref["loss"]))
    gn_gap = abs(prog["grad_norm"][0] - ref["grad_norm"][0]) \
        / ref["grad_norm"][0]
    med = statistics.median(ref["first_grad"].values())
    still = [k for k, v in ref["first_grad"].items() if v < 1e-3 * med]
    g = leaf_gaps(first, ref["first_grad"])
    m = leaf_gaps(moved, ref["moved"], skip=still)
    out = [("loss_gap", loss_gap), ("grad_norm_gap", gn_gap),
           ("grad_leaf_gap", max(g.values())),
           ("move_leaf_gap", max(m.values()))]
    if prog.get("routes") and ref.get("routes"):
        out.append(("route_mismatch", route_mismatch(prog["routes"],
                                                      ref["routes"])))
    if leaves:
        out += [("still_leaves", ["/".join(k) for k in still]),
                ("grad_leaves", {"/".join(k): v for k, v in g.items()}),
                ("move_leaves", {"/".join(k): v for k, v in m.items()})]
    return out


def compare(config, traffic, shapes, seed, dev, n, prog, first, moved,
            limits, t0) -> list:
    ref = reference_readings(config, traffic, shapes, seed, dev, n,
                             traffic["ref_steps"])
    read = dict(gaps(prog, first, moved, ref, leaves=True))
    harness.log(t0, "not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in read.items()
        if k not in limits and not k.endswith("leaves"))
        + f"; leaves left out of the change: {read['still_leaves']}")
    return [(name, read[name], limits[name]) for name in limits]
