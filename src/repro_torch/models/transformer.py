"""Decoder-only transformer LM, ``lm`` and ``moe`` families (the
reference's ``repro/models/transformer.py``): pre-norm GQA attention
(optionally with qkv bias or qk-norm) + gated MLP or MoE blocks, tied
embeddings.

Layer parameters are stacked along a leading ``layers`` dimension, as the
reference stacks them for its ``scan``; the forward unbinds them once (one
gradient buffer per stacked leaf in the backward) and loops.  Serving
(``prefill`` / ``decode_step``) keeps the reference's KV cache; the port
writes it in place.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import layers as L
from .moe import MoECfg, init_moe, moe_layer


def attn_cfg(cfg) -> L.AttnCfg:
    return L.AttnCfg(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                     head_dim=cfg.head_dim_, qkv_bias=cfg.qkv_bias,
                     qk_norm=cfg.qk_norm, window=cfg.window,
                     rope_theta=cfg.rope_theta)


def moe_cfg(cfg) -> MoECfg:
    """As the reference's: ``cfg.moe_renorm`` is not passed, so the top-k
    gates are renormalised (``MoECfg.renorm``'s default) in every config."""
    return MoECfg(d_model=cfg.d_model, n_experts=cfg.n_experts,
                  n_experts_padded=cfg.n_experts_padded, top_k=cfg.top_k,
                  d_expert=cfg.d_expert, n_shared=cfg.n_shared,
                  group_size=cfg.moe_group_size,
                  capacity_factor=cfg.moe_capacity_factor)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg, gen, device="cpu"):
    p = {
        "ln1": L.init_rmsnorm(cfg.d_model, device),
        "attn": L.init_attention(gen, attn_cfg(cfg), device),
        "ln2": L.init_rmsnorm(cfg.d_model, device),
    }
    if cfg.is_moe:
        p["moe"] = init_moe(gen, moe_cfg(cfg), device)
    else:
        p["mlp"] = L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, device)
    return p


def init_lm(cfg, gen: torch.Generator, device="cpu"):
    """Parameters drawn from ``gen`` (a generator on ``device``).  The
    numbers differ from the reference's ``jax.random`` ones; the tree, the
    shapes and the scales are the same."""
    return {
        "embed": L.init_embedding(gen, cfg.vocab_padded, cfg.d_model, device),
        "layers": L.init_stacked(lambda: init_layer(cfg, gen, device),
                                 cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _unbind(tree):
    if isinstance(tree, dict):
        per = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return tree.unbind(0)


def _block(cfg, lp, x, positions, kv_cache=None, cache_len=None,
           fresh=False):
    """One layer: ``(x, aux)``, aux the MoE's losses (empty for a dense
    MLP)."""
    x = L.seq_hint(x)   # residual stream sequence-sharded between layers
    h, _ = L.attention(lp["attn"], attn_cfg(cfg), L.rmsnorm(lp["ln1"], x),
                       positions, kv_cache=kv_cache, cache_len=cache_len,
                       fresh=fresh, q_block=cfg.q_block,
                       kv_block=cfg.kv_block)
    # each branch joins the stream through its own hint, so that on
    # DTensors its gradient comes back in the branch's own placement
    x = x + L.seq_hint(h)
    h2 = L.rmsnorm(lp["ln2"], x)
    if cfg.is_moe:
        out, aux = moe_layer(lp["moe"], moe_cfg(cfg), h2)
    else:
        out, aux = L.glu_mlp(lp["mlp"], h2, cfg.mlp_kind), {}
    return x + L.seq_hint(out), aux


def hidden_states(cfg, params, tokens, *, cache=None, cache_len=None,
                  last_only=False):
    """tokens: (B, S) int.  Returns ``(hidden, aux)``: the final-normed
    hidden states (B, S, d), only the last position with ``last_only``,
    and each auxiliary loss averaged over the layers (none without MoE).

    cache: ``(k, v)``, each (L, B, S_max, KV, hd), holding ``cache_len``
    valid positions; the new keys and values are written into it in
    place.  At ``cache_len`` 0 (a prefill) attention runs over the fresh
    keys, through the flash attention kernel on CUDA tensors."""
    x = L.embed(params["embed"], tokens, dtype=cfg.act_dtype)
    base = 0 if cache_len is None else cache_len
    positions = base + torch.arange(tokens.shape[1], device=tokens.device)
    fresh = cache is not None and cache_len == 0
    per_layer = []
    for i, lp in enumerate(_unbind(params["layers"])):
        kv = None if cache is None else (cache[0][i], cache[1][i])
        x, aux = L.remat(cfg, _block, cfg, lp, x, positions, kv, cache_len,
                         fresh)
        per_layer.append(aux)
    if last_only:
        x = x[:, -1:]
    aux = {k: torch.stack([a[k] for a in per_layer]).mean()
           for k in per_layer[0]}
    return L.rmsnorm(params["final_norm"], x), aux


def forward(cfg, params, tokens, *, cache=None, cache_len=None,
            last_only=False):
    """Logits (B, S, vocab_padded) of :func:`hidden_states`."""
    x, _ = hidden_states(cfg, params, tokens, cache=cache,
                         cache_len=cache_len, last_only=last_only)
    return L.unembed(params["embed"], x, cfg.vocab)


def loss_fn(cfg, params, batch):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1), plus
    ``aux_loss_weight`` times each auxiliary loss; metrics ``xent`` (that
    total, as in the reference) and the auxiliary losses."""
    tokens = batch["tokens"]
    hidden, aux = hidden_states(cfg, params, tokens[:, :-1])
    loss = L.chunked_unembed_xent(params["embed"], hidden, tokens[:, 1:],
                                  cfg.vocab)
    for v in aux.values():
        loss = loss + cfg.aux_loss_weight * v
    return loss, {"xent": loss, **aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu"):
    """Zeroed ``(k, v)`` caches of shape (L, B, max_len, KV, hd), in bf16
    by default as in the reference."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim_)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def prefill(cfg, params, tokens, max_len):
    """Run the prompt while writing a fresh ``max_len`` cache; returns the
    last position's logits (B, vocab_padded) and the cache."""
    if isinstance(tokens, DTensor):
        shape = (cfg.n_layers, tokens.shape[0], max_len, cfg.n_kv,
                 cfg.head_dim_)
        cache = tuple(L.cache_zeros(shape, torch.bfloat16, tokens)
                      for _ in range(2))
    else:
        cache = init_cache(cfg, tokens.shape[0], max_len,
                           device=tokens.device)
    logits = forward(cfg, params, tokens, cache=cache, cache_len=0,
                     last_only=True)
    return logits[:, -1], cache


def decode_step(cfg, params, cache, tokens, cache_len):
    """One-token decode: tokens (B, 1) at position ``cache_len``.  The
    cache is updated in place and returned."""
    logits = forward(cfg, params, tokens, cache=cache, cache_len=cache_len)
    return logits[:, -1], cache
