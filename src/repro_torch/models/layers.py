"""Shared layers of the port's models: the stacked-layer init, norms (RMS,
and the layer norm of ``rwkv6`` and ``encdec``), rotary embeddings, GQA
attention (with the optional qkv bias and qk-norm, causal or full), the
gated and the dense GELU MLP, embeddings and the chunked cross-entropy.

Every layer loop runs its body through :func:`remat`, the reference's
``jax.checkpoint`` under ``cfg.remat``.

Parameters are plain dicts of tensors that mirror the reference's tree key
for key (``repro/models/layers.py``).  The casts follow the reference
exactly: parameters stay f32 and are cast to the activation dtype where
they are used; norms and the softmax run in f32.  Attention is plain
matmuls, an f32 softmax and the ``-1e30`` mask, as the reference computes
it outside any kernel (blockwise, in ``cfg.q_block`` x ``cfg.kv_block``
blocks), except a prefill's attention over fresh keys on the card, which
runs through the flash attention kernel.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import attention as flash_attention

# f32 matrix products run in full f32 on the card, as in the reference
torch.backends.cuda.matmul.allow_tf32 = False


def remat(cfg, fn, *args, **kw):
    """``fn(*args, **kw)``; while autograd records and ``cfg.remat`` is
    set, under ``torch.utils.checkpoint`` (as the reference wraps each
    layer body in ``jax.checkpoint``): the body's activations are not
    kept for the backward but recomputed there.  Prefill and decode run
    without a gradient and are untouched."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


# ---------------------------------------------------------------------------
# sharding hints
# ---------------------------------------------------------------------------
#
# The reference's ``with_sharding_constraint`` hints.  On a DTensor whose
# mesh has the axes named, each is a ``redistribute`` to the reference's
# placement of those dims (every other dim replicated); on anything else,
# or where the dim does not divide, it returns the same tensor object, so
# the plain path is untouched.

_DATA_AXES = ("pod", "data")


def _hint(x, dims: dict):
    """``x`` redistributed so that tensor dim ``i`` is split over the mesh
    axes ``dims[i]`` (a tuple of names), everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for i, axes in dims.items():
        for a in axes:
            out[names.index(a)] = Shard(i)
    return x.redistribute(x.device_mesh, out)


def _mesh_sizes(x) -> dict:
    """Axis name -> extent of a DTensor's mesh, its axes of extent 1 left
    out (a split over one device is no split)."""
    if not isinstance(x, DTensor) or x.device_mesh.mesh_dim_names is None:
        return {}
    return {a: n for a, n in zip(x.device_mesh.mesh_dim_names,
                                 x.device_mesh.shape) if n > 1}


def _is_split(x) -> bool:
    """Whether ``x`` is a DTensor split over some mesh axis."""
    return isinstance(x, DTensor) and any(p.is_shard()
                                          for p in x.placements)


def _whole(w, dims):
    """A DTensor weight with its splits of ``dims`` gathered, for a
    product that flattens those dims behind another: DTensor cannot
    flatten a split that is not the group's leading dim without a
    redistribution (torch 2.11 refuses it).  Anything else as it is."""
    if not isinstance(w, DTensor) or not any(
            p.is_shard(d) for p in w.placements for d in dims):
        return w
    from torch.distributed.tensor import Replicate
    return w.redistribute(w.device_mesh, [
        Replicate() if any(p.is_shard(d) for d in dims) else p
        for p in w.placements])


def _data_axes(x, sizes: dict, batch_dim: int = 0):
    """The data axes ``x``'s dim ``batch_dim`` can be split over, or
    ``()`` where it does not divide."""
    names = tuple(a for a in _DATA_AXES if a in sizes)
    total = int(np.prod([sizes[a] for a in names] or [1]))
    if not names or x.dim() <= batch_dim or x.shape[batch_dim] % total \
            or x.shape[batch_dim] < total:
        return ()
    return names


def batch_hint(x, batch_dim: int = 0):
    """Split an activation's batch dim over the data axes (the
    reference's ``batch_hint``: it keeps values that start from a fresh
    zeros or a gather batch-sharded)."""
    sizes = _mesh_sizes(x)
    names = _data_axes(x, sizes, batch_dim)
    if not names:
        return x
    return _hint(x, {batch_dim: names})


def _model_hint(x, dim: int):
    """Split dim ``dim`` over ``model`` and dim 0 over the data axes where
    they divide; ``None`` where ``dim`` does not divide."""
    sizes = _mesh_sizes(x)
    n = sizes.get("model")
    if not n or x.dim() <= dim or x.shape[dim] % n or x.shape[dim] < n:
        return None
    dims = {dim: ("model",)}
    names = _data_axes(x, sizes)
    if names and dim != 0:
        dims[0] = names
    return _hint(x, dims)


def seq_hint(x, seq_dim: int = 1):
    """Megatron-SP-style hint (the reference's ``seq_hint``): split an
    activation's sequence dim over ``model`` (and its batch dim over the
    data axes), as the residual stream lies between layers."""
    out = _model_hint(x, seq_dim)
    return x if out is None else out


def cache_zeros(shape, dtype, like):
    """A zeroed ``(L, B, S, KV, hd)`` cache on the mesh of the DTensor
    ``like``, placed as the reference's ``init_cache`` axes place it
    (batch over the data axes, the kv heads or else the head dim over
    ``model``): each rank makes only its own shard, from ``like``'s local
    tensor (no communication, and fake where that is fake)."""
    from ..dist.sharding import local_shape, placements, spec_for
    mesh = like.device_mesh
    spec = spec_for(("layers", "batch", None, "kv_heads", "head_dim"),
                    shape, mesh, fsdp=False)
    local = like.to_local().new_zeros(local_shape(spec, shape, mesh),
                                      dtype=dtype)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def head_hint(x, head_dim: int):
    """Split dim ``head_dim`` over ``model`` (plus the batch over the data
    axes on dim 0); where it does not divide, :func:`batch_hint`."""
    out = _model_hint(x, head_dim)
    return batch_hint(x) if out is None else out


def local_rows(fn, *xs, whole=()):
    """``fn(*xs)`` on each rank's own rows, for an ``fn`` that treats the
    rows of dim 0 apart (a scan along the sequence, attention): the
    reference's ``shard_map`` / ``local_map`` over the batch split.

    Where some ``xs`` are DTensors, each tensor is placed with its dim 0
    split over the data axes (as :func:`batch_hint` splits it; those at
    the indices ``whole`` and every other dim whole), ``fn`` runs on the
    local tensors, so that no op inside it pays DTensor's dispatch, and
    its tensor outputs, each with the rows on dim 0, come back as
    DTensors of that placement.  The gradient of a whole input is each
    rank's sum over its rows, a partial sum over the data axes.  A plain
    tensor beside them is placed the same way (its rows cut from it, no
    communication).  Anything that is not a tensor passes as it is.  On
    plain tensors: ``fn(*xs)``.
    """
    like = next((x for i, x in enumerate(xs) if isinstance(x, DTensor)
                 and i not in whole), None)
    if like is None:
        return fn(*xs)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = like.device_mesh
    names = _data_axes(like, _mesh_sizes(like))
    rows = [Shard(0) if a in names else Replicate()
            for a in mesh.mesh_dim_names]
    n_rows = int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                          for a in names] or [1]))
    replicated = [Replicate()] * mesh.ndim
    summed = [Partial() if a in names else Replicate()
              for a in mesh.mesh_dim_names]

    def local(i, x):
        if not isinstance(x, torch.Tensor):
            return x
        if i in whole and not isinstance(x, DTensor):
            return x
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, replicated, run_check=False)
        if i in whole:
            return x.redistribute(mesh, replicated).to_local(
                grad_placements=summed)
        return x.redistribute(mesh, rows).to_local()

    def placed(y):
        if not isinstance(y, torch.Tensor):
            return y
        # contiguous, as the strides the DTensor is given say: DTensor
        # decides whether a view is possible from those
        shape = (y.shape[0] * n_rows,) + tuple(y.shape[1:])
        return DTensor.from_local(
            y.contiguous(), mesh, rows, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    out = fn(*(local(i, x) for i, x in enumerate(xs)))
    if isinstance(out, tuple):
        return tuple(placed(y) for y in out)
    return placed(out)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def ninit(gen, shape, scale=None, device="cpu"):
    """Normal init scaled by ``1/sqrt(shape[0])`` of the shape given (the
    per-layer shape for stacked layers), or by ``scale``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * float(scale)


def zinit(shape, device="cpu"):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init_stacked(make, n):
    """``n`` calls of ``make()`` (a tree of tensors) stacked along a new
    leading dimension.  Each stacked leaf is allocated once and filled
    layer by layer, in the order of the calls, so the peak is the stack
    plus one layer (``torch.stack`` of a list would hold every layer
    twice)."""
    first = make()
    out = _tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    _fill(out, first, 0)
    del first
    for i in range(1, n):
        _fill(out, make(), i)
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fill(dst, src, i):
    for key, val in src.items():
        if isinstance(val, dict):
            _fill(dst[key], val, i)
        else:
            dst[key][i] = val


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


def init_layernorm(d, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": zinit((d,), device)}


def layernorm(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta=10000.0):
    """x: (..., S, H, D); positions: (S,) int."""
    d = x.shape[-1]
    inv = torch.as_tensor(1.0 / (theta ** (np.arange(0, d, 2) / d)),
                          dtype=torch.float32, device=x.device)
    ang = positions[..., :, None].float() * inv             # (..., S, D/2)
    ang = ang[..., None, :]                                  # (..., S, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int | None = None       # sliding-window size (None = full)
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True


def init_attention(gen, cfg: AttnCfg, device="cpu"):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": ninit(gen, (d, h, hd), device=device),
        "wk": ninit(gen, (d, kv, hd), device=device),
        "wv": ninit(gen, (d, kv, hd), device=device),
        "wo": ninit(gen, (h, hd, d), scale=1.0 / np.sqrt(h * hd),
                    device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = zinit((h, hd), device)
        p["bk"] = zinit((kv, hd), device)
        p["bv"] = zinit((kv, hd), device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def attention(p, cfg: AttnCfg, x, positions, *, kv_cache=None,
              cache_len=None, cache_write_idx=None, cache_positions=None,
              mask_mode="causal", fresh=False, q_block=1024, kv_block=1024):
    """Self-attention, ``mask_mode`` "causal" or "full" (an encoder);
    returns ``(out, new_cache)``.

    x: (B, S, d); positions: (S,) int.  Without a cache, ``new_cache`` is
    the fresh ``(k, v)``.  kv_cache: ``(k_cache, v_cache)`` of shape
    (B, S_max, KV, hd) holding ``cache_len`` valid entries; the new keys
    and values are written at ``cache_len`` (a ring buffer: at slot
    ``cache_write_idx``, with ``cache_positions`` the absolute position of
    every slot, sentinel 1e9) in place, and the cache is returned.

    ``fresh=True`` is a prefill: the positions are 0..S-1 and the queries
    see only the S fresh keys (no cache, or an empty one), so on CUDA
    tensors attention runs through the flash attention kernel
    (``causal=False`` for a full mask, which ignores the window as the
    reference's mask does).  Everywhere else (training, decode, a prefill
    on another device) it is the blockwise :func:`sdpa` in ``q_block`` x
    ``kv_block`` blocks, as the reference computes it outside any kernel.
    """
    dt = x.dtype
    s = x.shape[1]
    # on DTensors: the sequence whole (the residual stream arrives split
    # by position) and the head dim of every weight whole, so that each
    # product flattens only dims whose split leads
    x = batch_hint(x)
    q = torch.einsum("bsd,dhk->bshk", x, _whole(p["wq"], (2,)).to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, _whole(p["wk"], (2,)).to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, _whole(p["wv"], (2,)).to(dt))
    if cfg.qkv_bias:
        q = q + _whole(p["bq"], (1,)).to(dt)
        k = k + _whole(p["bk"], (1,)).to(dt)
        v = v + _whole(p["bv"], (1,)).to(dt)
    if cfg.qk_norm:     # the reference's _headwise_rms: rmsnorm over hd
        q = rmsnorm({"scale": p["q_norm"]}, q)
        k = rmsnorm({"scale": p["k_norm"]}, k)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # on DTensors, attention runs batch-split with the heads whole on every
    # model rank (see sdpa)
    q, k, v = batch_hint(q), batch_hint(k), batch_hint(v)
    kv_pos, valid_len, new_cache = positions, None, (k, v)
    if kv_cache is not None:
        kc, vc = kv_cache
        wi = cache_len if cache_write_idx is None else cache_write_idx
        kc[:, wi:wi + s] = k.to(kc.dtype)
        vc[:, wi:wi + s] = v.to(vc.dtype)
        new_cache = (kc, vc)
        # the reference attends over the cache: keys and values rounded
        # through the cache's dtype
        if fresh:
            k, v = k.to(kc.dtype).to(dt), v.to(vc.dtype).to(dt)
        else:
            k, v = kc.to(dt), vc.to(dt)
            if cache_positions is not None:
                kv_pos = cache_positions
            else:
                kv_pos = torch.arange(kc.shape[1], device=x.device)
                valid_len = cache_len + s
    if fresh and q.device.type == "cuda":
        causal = mask_mode == "causal"
        out = flash_attention(q, k, v, causal=causal,
                              window=cfg.window if causal else None)
    else:
        out = sdpa(q, k, v, positions, kv_pos, cfg, mask_mode,
                   valid_len=valid_len, q_block=q_block, kv_block=kv_block)
    return torch.einsum("bshk,hkd->bsd", out,
                        _whole(p["wo"], (1,)).to(dt)), new_cache


def _mask(qp, kp, cfg: AttnCfg, mask_mode, valid_len=None):
    """(S, T) bool mask from positions (the reference's ``_block_mask``)."""
    m = (kp[None, :] < 10 ** 9).expand(qp.shape[0], kp.shape[0])
    if mask_mode == "causal":
        m = m & (kp[None, :] <= qp[:, None])
        if cfg.window is not None:
            m = m & (kp[None, :] > qp[:, None] - cfg.window)
    if valid_len is not None:
        m = m & (kp[None, :] < valid_len)
    return m


# score elements a (batch, head) holds in one step of :func:`sdpa`, unless
# one (q_block x kv_block) block is larger
STEP_SCORES = 1 << 22


def sdpa(q, k, v, q_pos, kv_pos, cfg: AttnCfg, mask_mode="causal",
         valid_len=None, q_block=1024, kv_block=1024):
    """Blockwise attention, the reference's ``sdpa``: an online softmax
    over ``kv_block`` key blocks for each ``q_block`` query block, in
    O(block^2) live scores.  For a causal mask over S == T with more than
    one query block, query block i visits only the key blocks
    ``[0, ceil((i+1) q_block / kv_block))``.  While autograd records,
    each step runs under ``torch.utils.checkpoint``: the backward keeps
    only the softmax carries and recomputes the step's scores.

    q: (B,S,H,D); k,v: (B,T,KV,D) -> (B,S,H,D); q_pos: (S,), kv_pos: (T,)
    (sentinel 1e9: masked).  Heads are grouped as the reference groups
    them: head ``h = kv * g + j``.  Keys at or past ``valid_len`` are
    masked.  On DTensors it runs on each rank's rows, the heads whole on
    every model rank (the grouping cannot cut heads split over the model
    axis where ``kv`` does not divide it)."""
    out = local_rows(functools.partial(
        _sdpa_blocks, cfg=cfg, mask_mode=mask_mode, q_block=q_block,
        kv_block=kv_block), q, k, v, q_pos, kv_pos, valid_len,
        whole=(3, 4, 5))
    # (on DTensors, split by heads for the output projection where they
    # divide the model axis)
    return head_hint(out, 2)


def _sdpa_blocks(q, k, v, q_pos, kv_pos, valid_len, *, cfg, mask_mode,
                 q_block, kv_block):
    """:func:`sdpa` on plain tensors.  The loop runs over the key blocks;
    each step updates every query block that sees its key block (in
    groups of at most ``STEP_SCORES`` scores a batch and head), so the
    loop is short at small blocks and the blocks computed are the
    reference's, each with the reference's arithmetic."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qb, kb = min(q_block, s), min(kv_block, t)
    s_pad, t_pad = -(-s // qb) * qb, -(-t // kb) * kb
    if s_pad != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
        q_pos = F.pad(q_pos, (0, s_pad - s), value=-(10 ** 9))
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
        kv_pos = F.pad(kv_pos, (0, t_pad - t), value=10 ** 9)
    nq, nk = s_pad // qb, t_pad // kb
    bk = b * kv
    # batched-product layouts, made once: queries (b kv, nq, g, qb, d),
    # keys (nk, b kv, d, kb) and values (nk, b kv, kb, d)
    qt = q.reshape(b, nq, qb, kv, g, d).permute(0, 3, 1, 4, 2, 5) \
        .reshape(bk, nq, g, qb, d)
    kt = k.reshape(b, nk, kb, kv, d).permute(1, 0, 3, 4, 2) \
        .reshape(nk, bk, d, kb)
    vt = v.reshape(b, nk, kb, kv, d).permute(1, 0, 3, 2, 4) \
        .reshape(nk, bk, kb, d)
    qpr, kpr = q_pos.reshape(nq, qb), kv_pos.reshape(nk, kb)
    triangle = mask_mode == "causal" and nq > 1 and s == t
    per = max(1, STEP_SCORES // (qb * kb))      # query blocks a step
    groups = [(i, min(i + per, nq)) for i in range(0, nq, per)]

    def step(m, l_, acc, qg, kblk, vblk, qp, kp):
        n = qg.shape[1]
        mask = _mask(qp.reshape(-1), kp, cfg, mask_mode, valid_len)
        # the reference scales by a numpy f64 scalar, which promotes the
        # activation-dtype product to f32 before the scale
        logits = torch.bmm(qg.reshape(bk, n * g * qb, d), kblk).float() \
            * np.float32(1.0 / np.sqrt(d))
        logits = torch.where(mask.reshape(n, 1, qb, kb),
                             logits.reshape(bk, n, g, qb, kb), -1e30)
        m_blk = logits.amax(-1)
        m_new = m_blk.clamp_min(-1e30) if m is None \
            else torch.maximum(m, m_blk)
        p_ = torch.exp(logits - m_new[..., None])
        pv = torch.bmm(p_.to(qg.dtype).reshape(bk, n * g * qb, kb), vblk)
        pv = pv.float().reshape(bk, n, g, qb, d)
        if m is None:   # the first key block, from m = -1e30, l = acc = 0
            return m_new, p_.sum(-1), pv
        corr = torch.exp(m - m_new)
        return m_new, l_ * corr + p_.sum(-1), acc * corr[..., None] + pv

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        def run(*a):     # the block step's own checkpoint, not remat's
            return torch.utils.checkpoint.checkpoint(
                step, *a, use_reentrant=False, preserve_rng_state=False)
    else:
        run = step

    def final(l_, acc):
        return (acc / l_.clamp_min(1e-30)[..., None]).to(q.dtype)

    # per group: the carries of its blocks [start, hi) that later key
    # blocks still update, and the outputs of those before
    carries = [[lo, None, None, None] for lo, _ in groups]
    done = [[] for _ in groups]
    for j in range(nk):
        first = (j * kb) // qb if triangle else 0
        for r, (_, hi) in enumerate(groups):
            start, m, l_, acc = carries[r]
            o = min(max(first - start, 0), hi - start)
            if o:           # blocks no later key block reaches: final
                done[r].append(final(l_[:, :o], acc[:, :o]))
                start, m, l_, acc = start + o, m[:, o:], l_[:, o:], \
                    acc[:, o:]
            if start < hi:
                m, l_, acc = run(m, l_, acc, qt[:, start:hi], kt[j], vt[j],
                                 qpr[start:hi], kpr[j])
            carries[r] = [start, m, l_, acc]
    out = torch.cat([x for r, c in enumerate(carries)
                     for x in done[r] + [final(*c[2:])] if x.shape[1]],
                    1)                                    # (b kv,nq,g,qb,d)
    out = out.reshape(b, kv, nq, g, qb, d).permute(0, 2, 4, 1, 3, 5) \
        .reshape(b, s_pad, h, d)
    return out[:, :s]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_glu_mlp(gen, d, f, device="cpu"):
    return {"wi_gate": ninit(gen, (d, f), device=device),
            "wi_up": ninit(gen, (d, f), device=device),
            "wo": ninit(gen, (f, d), device=device)}


def glu_mlp(p, x, kind="swiglu"):
    # jax.nn.gelu defaults to the tanh approximation
    act = torch.nn.functional.silu if kind == "swiglu" \
        else functools.partial(torch.nn.functional.gelu, approximate="tanh")
    dt = x.dtype
    x = batch_hint(x)     # on DTensors: the sequence whole for the products
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", act(g) * u, p["wo"].to(dt))


def init_dense_mlp(gen, d, f, device="cpu"):
    return {"wi": ninit(gen, (d, f), device=device),
            "wo": ninit(gen, (f, d), device=device)}


def dense_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    dt = x.dtype
    h = torch.nn.functional.gelu(
        torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)), approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# embedding / unembedding / loss
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab_padded, d, device="cpu"):
    return {"table": ninit(gen, (vocab_padded, d), scale=0.02,
                           device=device)}


def embed(p, tokens, dtype=torch.bfloat16):
    table = p["table"].to(dtype)
    if _is_split(tokens) or _is_split(table):
        # DTensor's rule for index_put (the lookup's backward) fails on
        # torch 2.11 for split indices; the embedding op has a rule of its
        # own (its backward accumulates in another order: kept off
        # unsplit tensors, which stay bit for bit with plain ones)
        out = batch_hint(torch.nn.functional.embedding(tokens, table))
        if any(p.is_partial() for p in out.placements):
            # a batch too small to split: the lookup's partial sums over a
            # split vocab are reduced here, while DTensor still holds the
            # mask that reduction needs
            from torch.distributed.tensor import Replicate
            out = out.redistribute(out.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in out.placements])
        # the gradient comes back in this placement: a partial-sum
        # gradient could not turn into the lookup's masked partial sum
        return _GradAs.apply(out, out.placements)
    return table[tokens]


class _GradAs(torch.autograd.Function):
    """The identity, its gradient redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def unembed(p, x, vocab: int):
    """Logits against the (tied) embedding table; padded slots masked."""
    x = batch_hint(x)     # on DTensors: the sequence whole for the product
    logits = torch.einsum("bsd,vd->bsv", x, p["table"].to(x.dtype))
    vp = p["table"].shape[0]
    if vp != vocab:
        keep = torch.arange(vp, device=x.device)[None, None, :] < vocab
        logits = torch.where(keep, logits, -1e30)
    return logits


def chunked_unembed_xent(embed_p, x, labels, vocab: int, chunk: int = 512,
                         z_loss=1e-4):
    """Mean token cross-entropy (plus ``z_loss * lse**2``) over
    tied-embedding logits, in sequence chunks of ``chunk`` as the reference
    sums them (without its recompute: autograd keeps each chunk's logits).
    Labels ``-1`` are padding.  x: (B, S, d), labels (B, S)."""
    x = batch_hint(x)     # on DTensors: the sequence whole for the chunks
    b, s, _ = x.shape
    c = min(chunk, s)
    s_pad = -(-s // c) * c
    if s_pad != s:
        x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))
        labels = torch.nn.functional.pad(labels, (0, s_pad - s), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s_pad, c):
        xc, lc = x[:, i:i + c], labels[:, i:i + c]
        logits = unembed(embed_p, xc, vocab).float()
        lse = torch.logsumexp(logits, dim=-1)
        if isinstance(logits, DTensor) and any(
                p.is_shard(logits.dim() - 1) for p in logits.placements):
            # DTensor cannot gather along a split vocab: the label's logit
            # as a sum over the vocab with one term not zero
            hit = torch.arange(logits.shape[-1], device=logits.device) \
                == lc.clamp_min(0)[..., None]
            ll = torch.where(hit, logits, 0.0).sum(-1)
        else:
            ll = torch.gather(logits, -1, lc.clamp_min(0)[..., None])[..., 0]
        loss = lse - ll
        if z_loss:
            loss = loss + z_loss * lse ** 2
        valid = (lc >= 0).float()
        tot = tot + (loss * valid).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp_min(1.0)
