"""Multi-pod dry run (the reference's ``repro/launch/dryrun.py``): trace
every (architecture x input shape) cell on the production meshes with
fake CPU tensors (shapes and dtypes, no allocation), over a ``fake``
process group of 256 (or 512) ranks, and read per device:

  * the peak live bytes (the program recorder's count over the fake
    tensors: arguments plus everything the step makes), held against the
    H100's 80 GB -- the reference's ``memory_analysis()``;
  * dot FLOPs, bytes touched and collective bytes by kind
    (:func:`repro_torch.analysis.hlo.analyze_program` at the shards'
    local shapes) -- the reference's ``cost_analysis()`` and HLO parse;
  * the three roofline terms (:mod:`repro_torch.analysis.roofline`).

Every count is a host-side reckoning of what one rank's program issues,
not a time or a memory size read on a card.  A cell's ``trace_s`` is
its build and step on the host, where the reference reports its lower
and compile seconds.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.json]
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \
      --reduced          # the config's reduced() fields (tests)

The fake group is process-wide: run cells through this CLI (tests run it
in a subprocess).  The 2x16x16 mesh is built with its two pods' data axes
folded into one ``data`` axis of 32 (:func:`make_production_mesh`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.analysis.hlo import ProgramRecorder
from repro_torch.analysis.roofline import roofline
from repro_torch.dist import sharding as shd
from repro_torch.dist.steps import make_train_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves

HBM_BYTES = 80e9      # an H100 80GB's device memory


def init_fake_group(world: int) -> None:
    """A ``fake`` default group of ``world`` ranks, this process rank 0:
    collectives return at once and move nothing (once a process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"is up; the dry run needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor
    out = []
    for x in (tree_leaves(tree) if isinstance(tree, dict) else tree):
        if isinstance(x, dict):
            out += _locals(x)
        elif isinstance(x, (tuple, list)):
            out += _locals(list(x))
        elif isinstance(x, torch.Tensor):
            out.append(x.to_local() if isinstance(x, DTensor) else x)
    return out


def build_cell(arch: str, shape_name: str, mesh, sync_mode: str = "gspmd",
               fsdp: bool = True, cfg_overrides: dict | None = None):
    """Returns ``(step_fn, args, cfg, shape)``: the cell's step and its
    arguments, DTensors placed on ``mesh``.  Call it under a
    ``FakeTensorMode`` to make them of fake tensors, and run the step
    outside it: ops on fake tensors run in their mode by themselves (what
    the models make from their inputs is fake too), while DTensor's
    sharding propagation makes small real tensors of its own and reads
    them, which it cannot inside the mode.  A tensor a model makes from
    nothing but sizes is real: the blockwise attention's masks, one
    (query rows, key block) block a step, are the largest."""
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = cfg.shape(shape_name)
    if shape.kind != "train" and cfg.serve_q_block and not cfg_overrides:
        # serve-time attention blocks, as the reference sets them
        cfg = dataclasses.replace(cfg, q_block=cfg.serve_q_block,
                                  kv_block=cfg.serve_kv_block)
    if shape.kind == "decode" and shape.global_batch >= 16:
        # weights stay TP-resident at serve time; batch-1 long decode
        # keeps ZeRO-3 (smaller local reads + gather), as the reference
        fsdp = False
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    pshard = shd.tree_shardings(api.param_axes(), params, mesh, fsdp=fsdp)
    params = shd.distribute(params, pshard)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in api.input_specs(shape).items()}

    if shape.kind == "train":
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
        shape_names = shd.mesh_axes(mesh)
        step_fn = make_train_step(api, opt, shape_names[1], shape_names[0],
                                  mode=sync_mode, group=dist.group.WORLD,
                                  fsdp=fsdp)
        return step_fn, (params, opt.init(params), batch), cfg, shape

    from torch.distributed.tensor.experimental import implicit_replication

    def place_batch(b):
        axes = api.batch_axes(shape)
        return {k: shd.distribute(v, shd.Sharding(mesh, shd.spec_for(
            axes[k], v.shape, mesh, fsdp=False)))
            if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in b.items()}

    # the FSDP split is gathered where the weights are used, as in the
    # train step (the reference leaves that all-gather to XLA)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with implicit_replication():
                return api.prefill_fn(shd.gather_fsdp(params),
                                      place_batch(batch))
        return prefill_step, (params, batch), cfg, shape

    caches = api.init_cache(shape.global_batch, shape.seq_len)
    cshard = shd.tree_shardings(api.cache_axes(), caches, mesh, fsdp=False)
    caches = shd.distribute(caches, cshard)

    def decode_step(params, caches, batch):
        batch = dict(batch, cache_len=shape.seq_len - 1)
        with implicit_replication():
            return api.decode_fn(shd.gather_fsdp(params), caches,
                                 place_batch(batch))
    return decode_step, (params, caches, batch), cfg, shape


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             sync_mode: str = "gspmd", fsdp: bool = True,
             verbose: bool = True, cfg_overrides: dict | None = None
             ) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    init_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        step_fn, args, cfg, shape = build_cell(
            arch, shape_name, mesh, sync_mode, fsdp, cfg_overrides)
    rec = ProgramRecorder(fake_mode=fake)
    arg_bytes = rec.hold(_locals(list(args)))
    with rec:
        out = step_fn(*args)
    out_bytes = sum(t.untyped_storage().nbytes() for t in _locals([out]))
    del out
    t_trace = time.time() - t0
    st = rec.stats
    n_dev = mesh.size()
    terms = roofline(cfg, shape, mesh_name, n_dev, st.dot_flops,
                     st.bytes_touched, st.total_collective_bytes)
    coll = {"bytes": dict(st.collective_bytes),
            "counts": dict(st.collective_counts),
            "total_bytes": st.total_collective_bytes}
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "sync": sync_mode, "fsdp": fsdp,
        "trace_s": round(t_trace, 1),
        "flops": st.dot_flops, "bytes_accessed": st.bytes_touched,
        "collectives": coll,
        "loop_aware": {
            "dot_flops": st.dot_flops,
            "bytes_touched": st.bytes_touched,
            "collective_bytes": dict(st.collective_bytes),
            "collective_counts": dict(st.collective_counts),
            "total_collective_bytes": st.total_collective_bytes,
        },
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": rec.peak_bytes - arg_bytes,
            "generated_code_bytes": None,
            "peak_bytes": rec.peak_bytes,
        },
        "fits": rec.peak_bytes <= HBM_BYTES,
        "roofline": terms.row(),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {mesh_name} "
              f"({sync_mode}): OK  trace={t_trace:.1f}s")
        print(f"  memory: peak {rec.peak_bytes / 1e9:.3f} GB a device "
              f"({'fits' if result['fits'] else 'does NOT fit'} in "
              f"{HBM_BYTES / 1e9:.0f} GB), arguments "
              f"{arg_bytes / 1e9:.3f} GB")
        print(f"  counts: dot flops={st.dot_flops:.3e} "
              f"bytes={st.bytes_touched:.3e}")
        print(f"  collective bytes: {coll['total_bytes']:.3e} "
              f"{coll['counts']}")
        print(f"  roofline: {terms.dominant}-bound, compute "
              f"{terms.compute_s:.3e} s, memory {terms.memory_s:.3e} s, "
              f"collective {terms.collective_s:.3e} s")
    return result


def iter_cells():
    for name, cfg in configs.ARCHS.items():
        for shape in configs.LM_SHAPES:
            yield name, shape.name, shape.name in cfg.skip_shapes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sync", default="gspmd",
                    choices=["gspmd", "edst", "psum_dp"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's smoke-test-sized config")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    results = []
    if args.all:
        cells = list(iter_cells())
    else:
        cells = [(args.arch, args.shape, False)]
    for arch, shape_name, skipped in cells:
        mesh_name = "2x16x16" if args.multi_pod else "16x16"
        if skipped:
            cfg = configs.get(arch)
            results.append({"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "skipped": True,
                            "reason": cfg.skip_reason})
            print(f"[dryrun] {arch} x {shape_name}: SKIP "
                  f"({cfg.skip_reason})")
            continue
        overrides = None
        if args.reduced:
            full = configs.get(arch)
            red = full.reduced()
            overrides = {f.name: getattr(red, f.name)
                         for f in dataclasses.fields(red)
                         if getattr(red, f.name) != getattr(full, f.name)}
        try:
            results.append(run_cell(arch, shape_name, args.multi_pod,
                                    args.sync, not args.no_fsdp,
                                    cfg_overrides=overrides))
        except Exception as e:  # noqa: BLE001 -- report and continue the sweep
            traceback.print_exc()
            print(f"[dryrun] {arch} x {shape_name}: ERROR {e!r}")
            results.append({"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    failed = [r for r in results if "error" in r]
    print(f"[dryrun] done: {len(results) - len(failed)}/{len(results)} OK")
    if failed:
        print("[dryrun] failed: " + ", ".join(
            f"{r['arch']} x {r['shape']}" for r in failed))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
