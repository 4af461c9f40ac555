"""Encoder-decoder backbone (``encdec`` family, seamless-m4t-large-v2; the
reference's ``repro/models/encdec.py``) [arXiv:2308.11596].

The modality frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_enc, d).  Decoder: causal self-attention + cross-attention
over encoder states, KV-cache decode with precomputed cross K/V.  LayerNorm
+ GELU dense MLP, per the m4t transformer family.

Attention runs through the flash attention kernel on every prefill on
the card (``fresh=True``, which the serving callers set, on CUDA
tensors): the encoder's (full mask), the decoder's self-attention (causal,
over the fresh keys of a cache-less prefill or of a cache filled at
``cache_len`` 0) and the cross-attention over the encoder's keys (full,
S_dec x T_enc).  The loss's encoder and decoder self-attention on the
card take the flash kernels, forward and backward, where
:func:`L.attention` finds that they compute what ``sdpa`` does.  The
loss's cross-attention, single-token decode steps and the rest run the
blockwise :func:`L.sdpa` in ``cfg.q_block`` x ``cfg.kv_block`` blocks, as
the reference computes it outside any kernel.  Layer parameters are
stacked along a leading ``layers`` dimension, as the reference stacks
them for its ``scan``; the forward unbinds them and loops.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.flash_attention.ops import attention as flash_attention
from . import layers as L
from .transformer import _unbind, attn_cfg


def _ccfg(cfg) -> L.AttnCfg:
    """Cross-attention config: no rope, full mask."""
    return dataclasses.replace(attn_cfg(cfg), use_rope=False, causal=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_enc_layer(cfg, gen, device="cpu"):
    return {"ln1": L.init_layernorm(cfg.d_model, device),
            "attn": L.init_attention(gen, attn_cfg(cfg), device),
            "ln2": L.init_layernorm(cfg.d_model, device),
            "mlp": L.init_dense_mlp(gen, cfg.d_model, cfg.d_ff, device)}


def init_dec_layer(cfg, gen, device="cpu"):
    return {"ln1": L.init_layernorm(cfg.d_model, device),
            "attn": L.init_attention(gen, attn_cfg(cfg), device),
            "lnc": L.init_layernorm(cfg.d_model, device),
            "cross": L.init_attention(gen, _ccfg(cfg), device),
            "ln2": L.init_layernorm(cfg.d_model, device),
            "mlp": L.init_dense_mlp(gen, cfg.d_model, cfg.d_ff, device)}


def init_encdec(cfg, gen: torch.Generator, device="cpu"):
    """Parameters drawn from ``gen`` (a generator on ``device``).  The
    numbers differ from the reference's ``jax.random`` ones; the tree, the
    shapes and the scales are the same."""
    d = cfg.d_model
    return {
        "frame_proj": {"w": L.ninit(gen, (d, d), device=device)},
        "embed": L.init_embedding(gen, cfg.vocab_padded, d, device),
        "enc": L.init_stacked(lambda: init_enc_layer(cfg, gen, device),
                              cfg.n_layers),
        "dec": L.init_stacked(lambda: init_dec_layer(cfg, gen, device),
                              cfg.n_dec_layers),
        "enc_norm": L.init_layernorm(d, device),
        "dec_norm": L.init_layernorm(d, device),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg, params, frames, *, fresh=False):
    """frames: (B, S, d) precomputed frame embeddings (frontend stub).
    ``fresh=True`` (serving) runs the full-mask attention on CUDA tensors
    through the flash kernel, which needs S aligned to its key block for
    S > 512."""
    dt = cfg.act_dtype
    x = torch.einsum("bsd,de->bse", frames.to(dt),
                     params["frame_proj"]["w"].to(dt))
    pos = torch.arange(frames.shape[1], device=frames.device)
    for lp in _unbind(params["enc"]):
        x = L.remat(cfg, _enc_block, cfg, lp, x, pos, fresh)
    return L.layernorm(params["enc_norm"], x)


def _enc_block(cfg, lp, x, pos, fresh):
    o, _ = L.attention(lp["attn"], attn_cfg(cfg), L.layernorm(lp["ln1"], x),
                       pos, mask_mode="full", fresh=fresh,
                       q_block=cfg.q_block, kv_block=cfg.kv_block)
    x = x + o
    return x + L.dense_mlp(lp["mlp"], L.layernorm(lp["ln2"], x))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _cross_proj(lp, enc_out):
    ck = torch.einsum("bsd,dhk->bshk", enc_out,
                      lp["cross"]["wk"].to(enc_out.dtype))
    cv = torch.einsum("bsd,dhk->bshk", enc_out,
                      lp["cross"]["wv"].to(enc_out.dtype))
    return ck, cv


def _dec_block(cfg, lp, x, positions, enc_kv=None, enc_out=None,
               self_cache=None, cache_len=None, fresh=False):
    o, new_self = L.attention(lp["attn"], attn_cfg(cfg),
                              L.layernorm(lp["ln1"], x), positions,
                              kv_cache=self_cache, cache_len=cache_len,
                              fresh=fresh, q_block=cfg.q_block,
                              kv_block=cfg.kv_block)
    x = x + o
    # cross-attention: K/V either precomputed (serving) or computed here
    # from enc_out
    ck, cv = enc_kv if enc_kv is not None else _cross_proj(lp, enc_out)
    h = L.layernorm(lp["lnc"], x)
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", h, lp["cross"]["wq"].to(dt))
    ck, cv = ck.to(dt), cv.to(dt)
    if fresh and q.device.type == "cuda":
        out = flash_attention(q, ck, cv, causal=False)
    else:
        out = L.sdpa(q, ck, cv, positions,
                     torch.arange(ck.shape[1], device=x.device), _ccfg(cfg),
                     mask_mode="full", q_block=cfg.q_block,
                     kv_block=cfg.kv_block)
    x = x + torch.einsum("bshk,hkd->bsd", out, lp["cross"]["wo"].to(dt))
    x = x + L.dense_mlp(lp["mlp"], L.layernorm(lp["ln2"], x))
    return x, new_self


def cross_kv(cfg, params, enc_out):
    """Precompute the (L_dec, B, S_enc, kv, hd) cross K/V from the encoder
    output, layer by layer into preallocated stacks."""
    layers = _unbind(params["dec"])
    b, s, _ = enc_out.shape
    shape = (len(layers), b, s, cfg.n_kv, cfg.head_dim_)
    ck = torch.empty(shape, dtype=enc_out.dtype, device=enc_out.device)
    cv = torch.empty_like(ck)
    for i, lp in enumerate(layers):
        ck[i], cv[i] = _cross_proj(lp, enc_out)
    return L.head_hint(ck, 3), L.head_hint(cv, 3)


def decode(cfg, params, tokens, enc_out=None, *, self_cache=None,
           cache_len=None, ckv=None, last_only=False, return_hidden=False,
           fresh=False):
    """tokens: (B, S_dec).  Returns ``(logits, new_self_cache)``.  Cross K/V
    may be passed precomputed (``ckv``, serving) or derived from
    ``enc_out``.  ``self_cache``: ``(k, v)``, each (L, B, S_max, KV, hd),
    holding ``cache_len`` valid positions, written in place.

    ``fresh=True`` is a prefill (no cache, or one at ``cache_len`` 0): on
    CUDA tensors the self- and cross-attention run through the flash
    kernel."""
    if fresh and cache_len:
        raise ValueError("fresh=True is a prefill: cache_len must be 0")
    x = L.embed(params["embed"], tokens, dtype=cfg.act_dtype)
    base = 0 if cache_len is None else cache_len
    positions = base + torch.arange(tokens.shape[1], device=tokens.device)
    for i, lp in enumerate(_unbind(params["dec"])):
        kv = None if self_cache is None else (self_cache[0][i],
                                              self_cache[1][i])
        enc_kv = None if ckv is None else (ckv[0][i], ckv[1][i])
        x, _ = L.remat(cfg, _dec_block, cfg, lp, x, positions,
                       enc_kv=enc_kv, enc_out=enc_out, self_cache=kv,
                       cache_len=cache_len, fresh=fresh)
    if last_only:
        x = x[:, -1:]
    x = L.layernorm(params["dec_norm"], x)
    if return_hidden:
        return x, self_cache
    return L.unembed(params["embed"], x, cfg.vocab), self_cache


def loss_fn(cfg, params, batch):
    """Next-token loss of ``batch["tokens"]`` (B, S + 1) given
    ``batch["frames"]`` (B, S_enc, d); plain attention throughout."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    hidden, _ = decode(cfg, params, tokens[:, :-1], enc_out,
                       return_hidden=True)
    loss = L.chunked_unembed_xent(params["embed"], hidden, tokens[:, 1:],
                                  cfg.vocab)
    return loss, {"xent": loss}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu"):
    """Zeroed decoder self-attention ``(k, v)`` caches of shape
    (L_dec, B, max_len, KV, hd), in bf16 by default as in the reference."""
    shape = (cfg.n_dec_layers, batch, max_len, cfg.n_kv, cfg.head_dim_)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step(cfg, params, cache, tokens, cache_len, cross_cache):
    """One-token decode at position ``cache_len``; ``cross_cache`` the
    precomputed ``(ck, cv)`` stacked over decoder layers.  The cache is
    updated in place and returned."""
    logits, cache = decode(cfg, params, tokens, self_cache=cache,
                           cache_len=cache_len, ckv=cross_cache)
    return logits[:, -1], cache
