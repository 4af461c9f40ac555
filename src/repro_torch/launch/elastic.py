"""Elastic rescaling and failure drills (the port's copy of the reference's
``repro/launch/elastic.py``): resume a checkpoint onto a DIFFERENT fabric,
rebuild the EDST collective schedule for it, and exercise the
precompiled failure-class schedules end to end.

The halves of elasticity here:
  * parameters / optimizer state: checkpoints store full host arrays;
    :func:`reshard_checkpoint` restores them onto the target device.  The
    port holds one replicated copy of the parameters whatever the number
    of data-parallel vertices, so moving to a new fabric is a change of
    the ``StackedFabric``'s vertex count and needs no re-placement;
  * collectives: the EDST packing is a function of the fabric, so a
    changed fabric (a resized data axis, a lost vertex excluded) gets a
    fresh maximal packing via the paper's constructions
    (:func:`rebuild_schedule`) or Roskind-Tarjan on an irregular residual
    fabric (:func:`rescale_after_node_loss`);
  * :func:`failure_drill` injects seeded link, burst and node failures
    into the DP fabric, picks each recovery (an id flip, a rebuild, a
    rescale), checks every chosen program with the packet simulator and
    reports the modelled bandwidth before and after;
  * :func:`chaos_loop` closes the loop: training on the 4x4 torus under
    a seeded chaos trace of all six kinds, every recovery taken, until a
    node loss checkpoints and rescales onto the survivors.

    python -m repro_torch.launch.elastic --ckpt-dir /tmp/ck \\
        --to-mesh 2,4,1 --arch smollm-135m
    python -m repro_torch.launch.elastic --failure-drill --to-mesh 4,4 \\
        --events 3

The checkpoint path runs on the CUDA device unless ``--device cpu`` is
given; the drill runs on the host only.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt import restore, save_checkpoint
from repro_torch.core.collectives import CostModel
from repro_torch.core.edst_rt import max_edsts
from repro_torch.core.fault import FailureEvent
from repro_torch.core.graph import Graph
from repro_torch.data import SyntheticLMStream
from repro_torch.dist.chaos import (KINDS, ChaosInjector, make_trace,
                                    out_of_class_burst)
from repro_torch.dist.fault import FaultAwareAllreduce, NoScheduleError
from repro_torch.dist.health import HealthMonitor
from repro_torch.dist.recovery import RecoveryController, RecoveryPolicy
from repro_torch.dist.steps import (dp_extent, edst_spec_for_mesh,
                                    fault_runtime_for_mesh, make_train_step)
from repro_torch.launch.train import parse_mesh, resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves


def reshard_checkpoint(cfg, opt, ckpt_dir: str, device):
    """Load the newest dense checkpoint in ``ckpt_dir`` onto ``device``.
    The template is ``init_lm`` of ``cfg`` (generator seed 0; every leaf
    is overwritten) and ``opt.init`` of it.  Returns ``(params,
    opt_state, step)``."""
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device)
    state, step, _ = restore(ckpt_dir, {"p": params, "o": opt.init(params)})
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return state["p"], state["o"], step


def rebuild_schedule(mesh_shape, axis_names):
    """EDST allreduce spec (pipelined, greedy schedule) for the (possibly
    new) DP fabric, or None when the mesh has no DP extent (one vertex:
    nothing to sync).  Rescales that land on an already-compiled fabric
    hit ``edst_spec_for_mesh``'s cache and return the IDENTICAL spec
    object."""
    if dp_extent(mesh_shape, axis_names) <= 1:
        return None
    return edst_spec_for_mesh(tuple(mesh_shape), tuple(axis_names))


def survivor_mesh(n_alive: int) -> tuple:
    """The ``(pod, data, model)`` mesh a run moves onto after a node loss
    leaves ``n_alive`` vertices: the largest power-of-two set of them, as
    a 2-D torus (8 -> (2, 4, 1), 4 -> (2, 2, 1), 2 -> (1, 2, 1)), so a
    power-of-two global batch still splits evenly."""
    if n_alive < 2:
        raise NoScheduleError(f"{n_alive} surviving vertex: nothing to "
                              "rescale onto")
    keep = 1 << (n_alive.bit_length() - 1)
    pod = 1 << ((keep.bit_length() - 1) // 2)
    return (pod, keep // pod, 1)


# Surviving-fabric runtimes, keyed by (n, surviving edge set, axes,
# engine): a drill (or a flapping node) that lands on an already-seen
# residual fabric reuses the runtime's entries -- every entry spec is the
# identical object -- instead of re-running Roskind-Tarjan and 2k+1 spec
# compiles per event.
_RESCALE_CACHE: dict = {}


def rescale_after_node_loss(runtime, event: FailureEvent) -> tuple:
    """Elastic node-loss recovery: drop the dead nodes entirely, relabel
    the surviving vertices 0..n'-1, repack a maximal EDST set on the
    residual fabric (Roskind-Tarjan), and build a fresh
    :class:`repro_torch.dist.fault.FaultAwareAllreduce` for it.  Returns
    ``(new_runtime, relabel)`` where ``relabel[old_vertex] == new_vertex``
    for every survivor.  Raises :class:`NoScheduleError` when the
    survivors are disconnected.

    Repeat rescales onto the same surviving fabric are served from
    ``_RESCALE_CACHE``: the returned runtime shares the cached entries
    (and reshard gather indices) object for object, with only the
    history fresh."""
    dead = event.dead_links(runtime.graph)
    residual = runtime.graph.without_edges(dead)
    alive = [v for v in range(runtime.graph.n) if v not in event.nodes]
    relabel = {v: i for i, v in enumerate(alive)}
    sub = Graph(len(alive),
                {(relabel[u], relabel[v]) for u, v in residual.edges
                 if u in relabel and v in relabel}, name="rescaled")
    if not sub.is_connected():
        raise NoScheduleError(
            f"surviving fabric ({len(alive)} nodes) disconnected; "
            "cannot rescale")
    key = (sub.n, frozenset(sub.edges), runtime.axes, runtime.engine)
    base = _RESCALE_CACHE.get(key)
    if base is None:
        trees, _ = max_edsts(sub)
        if not trees:
            raise NoScheduleError("surviving fabric packs no spanning tree")
        base = FaultAwareAllreduce.build(sub, trees, runtime.axes,
                                         engine=runtime.engine)
        _RESCALE_CACHE[key] = base
    new_rt = FaultAwareAllreduce(base.graph, base.axes, base.entries,
                                 engine=base.engine,
                                 _reshard_cache=base._reshard_cache)
    new_rt.history = runtime.history + [("rescaled", len(alive))]
    return new_rt, relabel


def failure_drill(runtime, n_events: int = 3, nbytes: float = 64 << 20,
                  seed: int = 0, cost_model: CostModel | None = None,
                  kinds=("link",)) -> dict:
    """Inject ``n_events`` seeded failures into the fabric (cycling
    through ``kinds``), observe the runtime's recovery choice after each,
    and report effective bandwidth: healthy -> recovered per event.

      * ``"link"``  -- a single-link kill: recovery is a precompiled
        schedule-id flip (``on_failure``), falling back to a dynamic
        repack only if no class survives;
      * ``"burst"`` -- an out-of-class multi-link burst (grown with
        :func:`repro_torch.dist.chaos.out_of_class_burst` until no
        precompiled class survives), forcing the ``with_rebuild``
        Roskind-Tarjan path;
      * ``"node"``  -- a node loss: checkpointless here, exercising
        :func:`rescale_after_node_loss` (relabel survivors + repack).
        The rescaled fabric has fewer vertices, so its ``bw_retained`` is
        relative to a *different* healthy baseline and may exceed 1.

    Events are independent -- each is injected into the healthy runtime.
    Each chosen schedule is validated with the packet-level simulator
    (``repro_torch.core.collectives.simulate_allreduce``), so the drill
    runs on the host alone."""
    cm = cost_model or CostModel()
    rng = np.random.RandomState(seed)
    healthy_bw = runtime.effective_bandwidth(nbytes, 0, cm)
    report = {"n": runtime.graph.n, "k": runtime.k, "nbytes": nbytes,
              "healthy_gbps": round(healthy_bw / 1e9, 3), "events": []}
    tree_links = sorted(set().union(
        *(ts.tree for ts in runtime.entries[0].sched.trees)))
    for i in range(n_events):
        kind = kinds[i % len(kinds)]
        if kind == "link":
            link = tree_links[rng.randint(len(tree_links))]
            event = FailureEvent(links=frozenset({link}))
            rec = {"event": i, "kind": "link", "dead_link": list(link)}
            try:
                rt = runtime.on_failure(event)      # precompiled: id flip only
                deg = runtime.on_failure(event, prefer="degraded")
                rec.update({
                    "schedule": rt.entry.name, "schedule_id": rt.active,
                    "k": rt.entry.k,
                    "depth": rt.entry.depth,
                    "sim_ok": rt.verify_entry(rt.active),
                    "gbps": round(rt.effective_bandwidth(nbytes, rt.active,
                                                         cm) / 1e9, 3),
                    "degraded_gbps": round(
                        deg.effective_bandwidth(nbytes, deg.active, cm)
                        / 1e9, 3),
                })
            except NoScheduleError:                 # dynamic repack
                rt = runtime.with_rebuild(event)
                rec.update({
                    "schedule": "with_rebuild", "schedule_id": 0, "k": rt.k,
                    "depth": rt.entry.depth,
                    "sim_ok": rt.verify_entry(0),
                    "gbps": round(rt.effective_bandwidth(nbytes, 0, cm)
                                  / 1e9, 3),
                })
        elif kind == "burst":
            burst = out_of_class_burst(runtime,
                                       np.random.default_rng(seed + i))
            event = FailureEvent(links=frozenset(burst))
            if runtime.valid_ids(event):
                raise AssertionError("out_of_class_burst left a "
                                     "precompiled class alive")
            rt = runtime.with_rebuild(event)
            rec = {"event": i, "kind": "burst",
                   "dead_links": sorted(list(e) for e in burst),
                   "schedule": "with_rebuild", "schedule_id": 0, "k": rt.k,
                   "depth": rt.entry.depth,
                   "sim_ok": rt.verify_entry(0),
                   "gbps": round(rt.effective_bandwidth(nbytes, 0, cm)
                                 / 1e9, 3)}
        elif kind == "node":
            v = int(rng.randint(runtime.graph.n))
            event = FailureEvent(nodes=frozenset({v}))
            rt, relabel = rescale_after_node_loss(runtime, event)
            rec = {"event": i, "kind": "node", "dead_node": v,
                   "schedule": "rescale", "schedule_id": 0,
                   "n_after": rt.graph.n, "k": rt.k,
                   "depth": rt.entry.depth,
                   "sim_ok": rt.verify_entry(0),
                   "gbps": round(rt.effective_bandwidth(nbytes, 0, cm)
                                 / 1e9, 3)}
        else:
            raise ValueError(f"unknown drill kind {kind!r} "
                             "(not in ('link', 'burst', 'node'))")
        rec["bw_retained"] = round(rec["gbps"] * 1e9 / healthy_bw, 3)
        report["events"].append(rec)
    return report


# The closed chaos loop's trace: seed 0 of all six kinds at gap 2, which
# has settled (the rescale landed, two steps trained on the survivors)
# by tick 20.
CHAOS_SEED, CHAOS_GAP, CHAOS_TICKS = 0, 2, 20
RECOVERIES = ("retry", "flip", "hot-swap", "rescale")


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree)])


def same_state(params, opt_state, other_params, other_state) -> bool:
    """Two dense (params, AdamW state) pairs equal bit for bit."""
    return (torch.equal(_flat(params), _flat(other_params))
            and int(opt_state.step) == int(other_state.step)
            and torch.equal(_flat(opt_state.mu), _flat(other_state.mu))
            and torch.equal(_flat(opt_state.nu), _flat(other_state.nu)))


def chaos_loop(device, cfg, batch_size: int, seq: int, ckpt_dir: str,
               check=None, say=print) -> dict:
    """The closed fault loop on the 4x4 torus (the dense configuration of
    the reference's chaos soak, ``benchmarks/chaos_soak.py``): the train
    step on the dense pipelined fault runtime, a seeded trace of all six
    chaos kinds (``make_trace(rt, CHAOS_TICKS, CHAOS_SEED, KINDS,
    CHAOS_GAP)``), the probe, the recovery controller, and the elastic
    rescale a node loss ends in.

    Each tick: ``advance`` the injector, probe the fabric with its
    ``fault_mask`` (the step time reported is the first committed step's,
    times ``time_dilation()``; the checksum spread the larger of the
    injection and the last step's ``sync_dev``), then commit a step
    unless the decision stalls, as the reference's soak does: a flip, a
    hot swap or a rescale runs its tick's step on the recovered program,
    which avoids every link the probe found dead.  While a background
    rebuild is in flight the controller is polled without advancing the
    injector, so the ticks are the same on any host.  (``launch.train
    --recover`` orders it the other way, as the reference's train loop
    does: it steps, then probes, and discards that step on any decision;
    with no injector it learns of a fault only from the step it ran.)

    A corruption rolls the last committed step back to its pre-step
    state and redoes it in the same tick (``redo_equal``: the redo equals
    the first attempt bit for bit).  A node loss checkpoints the state
    into ``ckpt_dir`` and rescales onto :func:`survivor_mesh` of the
    survivors, restored through :func:`reshard_checkpoint`
    (``restore_equal``: the state restored equals the state saved).
    ``check(tag, params, opt_state, batch, new_params, grad_norm, mesh,
    opt)``, when given, gets the first committed step after each recovery
    (retry, flip, hot swap, corruption redo, rescale); its results are
    ``checks``.  Exceptions are counted (``unhandled``), not raised, and
    end the loop.  ``commits[i]`` is the loss of batch ``i``."""
    mesh0, names = (4, 4, 1), ("pod", "data", "model")
    opt = AdamW(cosine_schedule(3e-4, 20, 100))
    stream = SyntheticLMStream(cfg.vocab, seq, batch_size, seed=CHAOS_SEED)
    runtime = fault_runtime_for_mesh(mesh0, names)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(
        CHAOS_SEED), device)
    st = {"mesh": mesh0, "params": params, "opt_state": opt.init(params),
          "restore_equal": None}
    del params

    def rebuild_exec(rt, straggler=None):
        st["step"] = make_train_step(cfg, opt, st["mesh"], names,
                                     mode="edst", fault_runtime=rt,
                                     telemetry=True)
        st["monitor"] = HealthMonitor(device, rt, straggler=straggler)

    rebuild_exec(runtime)
    trace = make_trace(runtime, CHAOS_TICKS, seed=CHAOS_SEED, kinds=KINDS,
                       gap=CHAOS_GAP)
    inj = ChaosInjector(trace)
    for ev in trace:
        say(f"chaos trace: {ev.describe()}")
    commits, checks, saved = [], [], {}

    def on_checkpoint():
        save_checkpoint(ckpt_dir, len(commits),
                        {"p": st["params"], "o": st["opt_state"]})
        saved.update(step=len(commits), params=st["params"],
                     opt_state=st["opt_state"])

    def on_rescale(event):
        mesh = survivor_mesh(ctrl.runtime.graph.n - len(event.nodes))
        new_rt = fault_runtime_for_mesh(mesh, names)
        params, opt_state, step = reshard_checkpoint(cfg, opt, ckpt_dir,
                                                     device)
        st["restore_equal"] = step == saved["step"] and same_state(
            params, opt_state, st["params"], st["opt_state"])
        say(f"chaos rescale: {sorted(event.nodes)} lost, checkpoint step "
            f"{step} restored onto mesh {mesh} (k={new_rt.k}), equal to "
            f"the state saved bit for bit: {st['restore_equal']}")
        st.update(mesh=mesh, params=params, opt_state=opt_state)
        inj.clear_fabric_state()
        return new_rt

    ctrl = RecoveryController(runtime, RecoveryPolicy(backoff_base_s=0.01),
                              on_checkpoint=on_checkpoint,
                              on_rescale=on_rescale)
    del runtime
    prev = None                 # the state before the last committed step
    pending = []                # recoveries whose first step is unchecked
    first_attempt = None        # a rolled-back step's params
    redo_equal, base_dt, last_dev = None, None, 0.0
    steps_lost = unhandled = 0
    step_seconds = []
    for tick in range(CHAOS_TICKS):
        try:
            fired = inj.advance()
            mask = inj.fault_mask(st["monitor"].plan)
            report = st["monitor"].check(
                tick, fault_mask=mask,
                step_time=None if base_dt is None
                else base_dt * inj.time_dilation(),
                checksum_dev=max(inj.checksum_injection(), last_dev))
            seen = len(ctrl.journal)
            t0 = time.perf_counter()
            dec = ctrl.observe(report)
            polls = 0
            while dec.stall and ctrl.state == "rebuilding":
                time.sleep(0.02)
                dec = ctrl.observe(report)
                polls += 1
                if polls > 30000:
                    raise RuntimeError("background rebuild never landed")
            if dec.runtime_changed:
                rebuild_exec(ctrl.runtime, straggler=st["monitor"].straggler)
            rows = ctrl.journal[seen:]
            pending += [f"{e.cause} -> {e.action}" for e in rows
                        if e.action in RECOVERIES]
            say(f"chaos tick {tick}: fired {[ev.kind for ev in fired]}, "
                f"decision {dec.action} (schedule {dec.schedule_id}, "
                f"stall {dec.stall}), {time.perf_counter() - t0!r}s"
                + "".join(f"; journal {e.cause} -> {e.action}" for e in rows))
            if dec.redo_step:
                if prev is not None and commits:
                    # the step committed last went over a corrupt wire:
                    # roll it back and recompute the same batch
                    first_attempt = st["params"]
                    st["params"], st["opt_state"] = prev
                    prev = None
                    commits.pop()
                    steps_lost += 1
            elif dec.stall:
                steps_lost += 1
                if dec.backoff_s:
                    time.sleep(min(dec.backoff_s, 0.05))
                continue
            i = len(commits)
            batch = {"tokens": torch.as_tensor(
                stream.batch(i), dtype=torch.long, device=device)}
            t0 = time.perf_counter()
            new_p, new_s, met = st["step"](st["params"], st["opt_state"],
                                           batch, ctrl.schedule_id)
            loss = float(met["loss"])        # waits for the step
            step_seconds.append(time.perf_counter() - t0)
            if base_dt is None:
                base_dt = step_seconds[-1]
            if first_attempt is not None:
                redo_equal = torch.equal(_flat(new_p), _flat(first_attempt))
                say(f"chaos redo of batch {i}: equal to its first attempt "
                    f"bit for bit: {redo_equal}")
                first_attempt = None
            if pending and check is not None:
                checks.append(check(
                    f"chaos step {i} after {', '.join(pending)}",
                    st["params"], st["opt_state"], batch, new_p,
                    met["grad_norm"], st["mesh"], opt))
            pending = []
            prev = (st["params"], st["opt_state"])
            st["params"], st["opt_state"] = new_p, new_s
            del new_p, new_s
            commits.append(loss)
            last_dev = float(met["sync_dev"])
            say(f"chaos tick {tick}: committed batch {i} on "
                f"{ctrl.runtime.entry.name} over {st['mesh']}, loss "
                f"{loss!r}, sync_dev {last_dev!r}, "
                f"{step_seconds[-1]!r}s")
        except Exception as exc:   # the loop's contract: count, never crash
            unhandled += 1
            say(f"chaos UNHANDLED at tick {tick}: {type(exc).__name__}: "
                f"{exc}\n{traceback.format_exc()}")
            break
    return {"commits": commits, "steps_lost": steps_lost,
            "unhandled": unhandled, "journal": ctrl.journal_rows(),
            "fired": [ev.kind for ev in inj.fired], "kinds": KINDS,
            "checks": checks, "redo_equal": redo_equal,
            "restore_equal": st["restore_equal"], "mesh": st["mesh"],
            "saved": saved, "params": st["params"],
            "opt_state": st["opt_state"], "ctrl": ctrl,
            "step_seconds": step_seconds, "ticks": CHAOS_TICKS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--to-mesh", required=True)
    ap.add_argument("--failure-drill", action="store_true",
                    help="no checkpoint: build the elastic EDST runtime for "
                         "the DP fabric of --to-mesh, inject failures, "
                         "report recovery + bandwidth as JSON")
    ap.add_argument("--events", type=int, default=3)
    ap.add_argument("--nbytes", type=int, default=64 << 20)
    ap.add_argument("--drill-kinds", default="link,burst,node",
                    help="comma list of failure kinds the drill cycles "
                         "through: link (schedule flip), burst "
                         "(out-of-class with_rebuild), node (elastic "
                         "rescale)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the restored state (default "
                         "cuda; the drill runs on the host)")
    args = ap.parse_args(argv)

    if args.failure_drill:
        dims = tuple(int(x) for x in args.to_mesh.split(","))
        runtime = fault_runtime_for_mesh((int(np.prod(dims)), 1),
                                         ("data", "model"),
                                         dp_torus_shape=dims)
        report = failure_drill(runtime, n_events=args.events,
                               nbytes=args.nbytes,
                               kinds=tuple(args.drill_kinds.split(",")))
        print(json.dumps(report, indent=2))
        return report

    if args.ckpt_dir is None:
        ap.error("--ckpt-dir is required unless --failure-drill")
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dims, names = parse_mesh(args.to_mesh)
    opt = AdamW(cosine_schedule(3e-4, 10, 100))
    params, opt_state, step = reshard_checkpoint(cfg, opt, args.ckpt_dir,
                                                 device)
    spec = rebuild_schedule(dims, names)
    k = spec.k if spec is not None else 0
    print(f"[elastic] resumed step {step} onto mesh {dims}; "
          f"EDST schedule rebuilt with k={k} trees")
    return params, opt_state, step


if __name__ == "__main__":
    main()
