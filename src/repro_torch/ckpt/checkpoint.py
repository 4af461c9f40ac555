"""Atomic npz checkpointing with resume and ZeRO-1 re-shard (the
reference's ``repro/ckpt/checkpoint.py``, in the same on-disk format, so a
checkpoint written by either package restores in the other).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
tmp dir and ``os.rename``'d (atomic on POSIX), so a crash mid-save never
corrupts the latest checkpoint.  Tensors go to numpy on save (a Python
int leaf, such as ``OptState.step``, as the reference's int32 scalar) and
come back on the template's device on restore.

ZeRO-1 owner-stripe state has its own pair of entry points
(:func:`save_sharded_checkpoint` / :func:`restore_sharded`): one
``shard_<v>.npz`` per owner vertex holds its ``(kmax, smax)`` stripe rows
of ``mu`` / ``nu`` and the element-id row saying which flat payload slot
each cell holds, with a CRC32 of every shard file in the manifest.
Restore re-assembles the flat vectors from the saved maps and re-scatters
them onto the *target* element map -- another failure class's, another
fabric's, another ``(kmax, smax)`` -- so a checkpoint taken on a healthy
fabric restores onto a re-striped one.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib

import numpy as np
import torch

from ..optim.sharded import ShardedOptState


def _file_crc32(path: str) -> int:
    """CRC32 of a file's bytes (streamed): the per-shard checksum the
    manifest records and :func:`restore_sharded` verifies."""
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _esc(k) -> str:
    """Escape one tree key for the "/"-joined flat namespace, so
    ``{"a": {"b/c": x}}`` and ``{"a/b": {"c": x}}`` stay apart."""
    return str(k).replace("%", "%25").replace("/", "%2F")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_esc(k)}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bool, int)):
        return np.asarray(x, np.int32)   # the reference's int32 scalars
    return np.asarray(x)


def _place(arr: np.ndarray, like):
    """A loaded array in the template leaf's form: an int for an int, a
    tensor on the template's device for a tensor."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(like.device)
    if isinstance(like, (bool, int)):
        return int(arr)
    return arr


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}{_esc(k)}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        typ = type(template)
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        if hasattr(typ, "_fields"):   # NamedTuple (e.g. OptState)
            return typ(*vals)
        return typ(vals) if typ is list else tuple(vals)
    return _place(flat[prefix[:-1]], template)


def _commit_step_dir(ckpt_dir: str, step: int, write_fn) -> str:
    """Shared atomic-publish path: ``write_fn(tmp_dir)`` stages the files,
    then one os.rename makes the step visible; keeps the 2 newest steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        write_fn(tmp)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-2]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

    def write(tmp):
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(arrays),
                       "extra": extra or {}}, f)

    return _commit_step_dir(ckpt_dir, step, write)


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: int):
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        return {k: npz[k] for k in npz.files}, manifest


def restore(ckpt_dir: str, template, step: int | None = None):
    """Restore into ``template``'s structure, each tensor on its template
    leaf's device.  Returns ``(tree, step, extra)`` or ``(None,) * 3``
    when the directory holds no checkpoint."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None, None
    flat, manifest = load_checkpoint(ckpt_dir, step)
    return _unflatten_into(template, flat), step, manifest.get("extra", {})


# ---------------------------------------------------------------------------
# ZeRO-1 owner-stripe checkpoints
# ---------------------------------------------------------------------------

def save_sharded_checkpoint(ckpt_dir: str, step: int, params,
                            opt_state: ShardedOptState, elem_map, size: int,
                            extra: dict | None = None):
    """Sharded ZeRO-1 save: params (replicated) go to ``arrays.npz``; each
    owner vertex ``v`` gets ``shard_<v>.npz`` with its ``mu`` / ``nu``
    stripe rows and the ``(kmax, smax)`` element-id row (-1 = padding).
    ``elem_map`` is the ``(n, kmax, smax)`` ownership map of the fabric
    the state was trained on (``owner_element_map`` for a plain spec,
    ``FaultAwareAllreduce.zero1_element_map`` for the active failure
    class)."""
    elem = np.asarray(elem_map)
    n = int(elem.shape[0])
    mu = _to_numpy(opt_state.mu)
    nu = _to_numpy(opt_state.nu)
    arrays = {k: _to_numpy(v) for k, v in _flatten(params).items()}

    def write(tmp):
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        checksums = {}
        for v in range(n):
            name = f"shard_{v:05d}.npz"
            np.savez(os.path.join(tmp, name), mu=mu[v], nu=nu[v],
                     elem=elem[v])
            checksums[name] = _file_crc32(os.path.join(tmp, name))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(arrays),
                       "sharded": {
                           "size": int(size), "n": n,
                           "kmax": int(elem.shape[1]),
                           "smax": int(elem.shape[2]),
                           "opt_step": int(opt_state.step),
                           "checksums": checksums},
                       "extra": extra or {}}, f)

    return _commit_step_dir(ckpt_dir, step, write)


def restore_sharded(ckpt_dir: str, params_template, elem_map,
                    step: int | None = None):
    """Restore a sharded ZeRO-1 checkpoint onto the fabric described by
    ``elem_map`` (the *target* ``(n', kmax', smax')`` ownership map: the
    save-time map gives the saved layout back bit for bit, another map
    re-shards).  The moments land on the params template's device.
    Returns ``(params, ShardedOptState, step, extra)`` or
    ``(None,) * 4`` when the directory holds no checkpoint."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None, None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    geom = manifest["sharded"]
    size = int(geom["size"])

    # torn or corrupt shards fail loudly BEFORE any state is assembled;
    # checkpoints without checksums load as before
    checksums = geom.get("checksums", {})
    mu_flat = np.zeros(size, np.float32)
    nu_flat = np.zeros(size, np.float32)
    for v in range(int(geom["n"])):
        name = f"shard_{v:05d}.npz"
        shard_path = os.path.join(path, name)
        if name in checksums and _file_crc32(shard_path) != checksums[name]:
            raise ValueError(
                f"sharded checkpoint corrupt: {shard_path} fails its "
                f"manifest CRC32 (expected {checksums[name]:#010x}); the "
                "shard was torn or altered after save -- restore an older "
                "step or re-save from a healthy replica")
        with np.load(shard_path) as shard:
            e = shard["elem"]
            mask = e >= 0
            mu_flat[e[mask]] = shard["mu"][mask]
            nu_flat[e[mask]] = shard["nu"][mask]

    tgt = np.asarray(elem_map)
    mu = np.zeros(tgt.shape, np.float32)
    nu = np.zeros(tgt.shape, np.float32)
    live = tgt >= 0
    mu[live] = mu_flat[tgt[live]]
    nu[live] = nu_flat[tgt[live]]
    del mu_flat, nu_flat

    with np.load(os.path.join(path, "arrays.npz")) as npz:
        params = _unflatten_into(params_template,
                                 {k: npz[k] for k in npz.files})
    leaf = params_template
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    device = leaf.device
    state = ShardedOptState(int(geom["opt_step"]),
                            torch.from_numpy(mu).to(device),
                            torch.from_numpy(nu).to(device))
    return params, state, step, manifest.get("extra", {})
