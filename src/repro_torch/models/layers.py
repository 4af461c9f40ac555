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
it outside any kernel, except a prefill's attention over fresh keys,
which runs through the flash attention kernel.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
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
              mask_mode="causal", fresh=False):
    """Self-attention, ``mask_mode`` "causal" or "full" (an encoder);
    returns ``(out, new_cache)``.

    x: (B, S, d); positions: (S,) int.  Without a cache, ``new_cache`` is
    the fresh ``(k, v)``.  kv_cache: ``(k_cache, v_cache)`` of shape
    (B, S_max, KV, hd) holding ``cache_len`` valid entries; the new keys
    and values are written at ``cache_len`` (a ring buffer: at slot
    ``cache_write_idx``, with ``cache_positions`` the absolute position of
    every slot, sentinel 1e9) in place, and the cache is returned.

    ``fresh=True`` is a prefill: the positions are 0..S-1 and the queries
    see only the S fresh keys (no cache, or an empty one), so attention
    runs through the flash attention kernel (``causal=False`` for a full
    mask, which ignores the window as the reference's mask does).
    Otherwise (training, decode) it is the plain :func:`sdpa`, as the
    reference computes it outside any kernel.
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
    if fresh:
        causal = mask_mode == "causal"
        out = flash_attention(q, k, v, causal=causal,
                              window=cfg.window if causal else None)
    else:
        out = sdpa(q, k, v, positions, kv_pos, cfg, mask_mode,
                   valid_len=valid_len)
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


def sdpa(q, k, v, q_pos, kv_pos, cfg: AttnCfg, mask_mode="causal",
         valid_len=None):
    """Softmax attention over all keys at once: the query-key product in
    the activation dtype, scaled and masked to ``-1e30`` in f32, an f32
    softmax whose weights are cast to the activation dtype for the value
    product, as the reference's blockwise ``sdpa`` does within one block.

    q: (B,S,H,D); k,v: (B,T,KV,D) -> (B,S,H,D).  Heads are grouped as the
    reference groups them: head ``h = kv * g + j``.  Keys at or past
    ``valid_len`` are masked."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    # on DTensors: batch-split only, the heads whole on every model rank
    # (the grouping cannot cut heads split over the model axis where
    # ``kv`` does not divide it, and the products below would flatten
    # the batch and a split head dim together)
    q, k, v = batch_hint(q), batch_hint(k), batch_hint(v)
    qg = q.reshape(b, s, kv, g, d)
    # the reference scales by a numpy f64 scalar, which promotes the
    # activation-dtype product to f32 before the scale
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() \
        * np.float32(1.0 / np.sqrt(d))
    mask = _mask(q_pos, kv_pos, cfg, mask_mode, valid_len)
    logits = torch.where(mask, logits, -1e30)
    m = logits.amax(-1).clamp_min(-1e30)
    p_ = torch.exp(logits - m[..., None])
    l_ = p_.sum(-1)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p_.to(q.dtype), v).float()
    out = (acc / l_.clamp_min(1e-30)[..., None]).to(q.dtype)
    # (on DTensors, split by heads for the output projection where they
    # divide the model axis)
    return head_hint(out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d), 2)


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
        return batch_hint(torch.nn.functional.embedding(tokens, table))
    return table[tokens]


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
