"""InternVL2-2B backbone (``vlm`` family; the reference's
``repro/models/vlm.py``) [arXiv:2404.16821]: InternViT frontend STUB
(precomputed patch embeddings) projected and prepended to the InternLM2
token stream; loss on text positions only.  Decode reuses the LM KV-cache
path (the image prefix lives in the cache after prefill).

The image prefix is causal with the text, as in the reference.  A prefill
(``fresh=True``: the cache-less prefill, or a cache filled at
``cache_len`` 0) on CUDA tensors runs its attention through the flash
attention kernel; the loss, decode steps and a prefill on another device
run the blockwise :func:`layers.sdpa`.
"""
from __future__ import annotations

import torch

from . import layers as L
from . import transformer as T


def init_vlm(cfg, gen: torch.Generator, device="cpu"):
    """Parameters drawn from ``gen``: the LM's, then the patch projection
    (the reference's tree, shapes and scales; other numbers)."""
    p = T.init_lm(cfg, gen, device)
    p["patch_proj"] = {"w": L.ninit(gen, (cfg.d_model, cfg.d_model),
                                    device=device)}
    return p


def forward(cfg, params, tokens, patches, *, cache=None, cache_len=None,
            last_only=False, return_hidden=False, fresh=False):
    """patches: (B, n_img, d) stub embeddings; tokens: (B, S_text).
    Returns ``(logits, cache)`` (or the final-normed hidden states with
    ``return_hidden``); ``cache`` as in :func:`transformer.hidden_states`,
    written in place."""
    if fresh and cache_len:
        raise ValueError("fresh=True is a prefill: cache_len must be 0")
    dt = cfg.act_dtype
    tok_emb = L.embed(params["embed"], tokens, dtype=dt)
    img_emb = torch.einsum("bnd,de->bne", patches.to(dt),
                           params["patch_proj"]["w"].to(dt))
    x = torch.cat([img_emb, tok_emb], dim=1)
    base = 0 if cache_len is None else cache_len
    positions = base + torch.arange(x.shape[1], device=x.device)
    for i, lp in enumerate(T._unbind(params["layers"])):
        kv = None if cache is None else (cache[0][i], cache[1][i])
        x, _ = L.remat(cfg, T._block, cfg, lp, x, positions, kv, cache_len,
                       fresh)
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params["final_norm"], x)
    if return_hidden:
        return x, cache
    return L.unembed(params["embed"], x, cfg.vocab), cache


def loss_fn(cfg, params, batch):
    """Next-token loss on the text of ``batch["tokens"]`` (B, S_text + 1)
    after ``batch["patches"]`` (B, n_img, d); plain attention."""
    tokens, patches = batch["tokens"], batch["patches"]
    hidden, _ = forward(cfg, params, tokens[:, :-1], patches,
                        return_hidden=True)
    n_img = patches.shape[1]
    loss = L.chunked_unembed_xent(params["embed"], hidden[:, n_img:],
                                  tokens[:, 1:], cfg.vocab)
    return loss, {"xent": loss}


init_cache = T.init_cache


def decode_step(cfg, params, cache, tokens, cache_len):
    """Image prefix already in the cache from prefill; pure-text decode."""
    logits = T.forward(cfg, params, tokens, cache=cache, cache_len=cache_len)
    return logits[:, -1], cache
