"""RecurrentGemma / Griffin (``rglru`` family, the reference's
``repro/models/rglru.py``): RG-LRU recurrent blocks and local
(sliding-window) MQA attention in a 1:2 pattern (rec, rec, attn)
[arXiv:2402.19427].

The RG-LRU recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)``
runs through the RG-LRU scan kernel for a prefill on the card, as one
plain step for decode, and otherwise (training; a prefill on another
device) as the reference's associative scan (:func:`rg_lru_scan`); a
prefill's local attention on the card runs through the flash attention
kernel.  The temporal conv1d is a width-4 causal depthwise convolution
written as shifted adds.

Decode state: the LRU state, the conv tail and a ring-buffer window KV
cache (slot = position % window, the absolute position of every slot in
``kv_pos``, sentinel 1e9), keyed and typed as the reference's.  The port
updates the caches in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.rglru.ops import lru_scan
from . import layers as L
from .transformer import _unbind, attn_cfg

C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness constant
SENTINEL = 10 ** 9


def _lru_width(cfg):
    return cfg.lru_width or cfg.d_model


def _layer_kinds(cfg):
    pat = cfg.pattern or ("rec", "rec", "attn")
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rec_layer(cfg, gen, device="cpu"):
    d, w = cfg.d_model, _lru_width(cfg)

    def zeros():
        return torch.zeros((w,), dtype=torch.float32, device=device)

    return {
        "ln": L.init_rmsnorm(d, device),
        "w_gate": L.ninit(gen, (d, w), device=device),
        "w_rec": L.ninit(gen, (d, w), device=device),
        "conv_w": L.ninit(gen, (cfg.conv_width, w), scale=0.1,
                          device=device),
        "conv_b": zeros(),
        "wa": L.ninit(gen, (w, w), device=device),     # recurrence gate r_t
        "ba": zeros(),
        "wi": L.ninit(gen, (w, w), device=device),     # input gate i_t
        "bi": zeros(),
        "lam": torch.as_tensor(np.linspace(0.9, 4.0, w), dtype=torch.float32,
                               device=device),
        "wo": L.ninit(gen, (w, d), device=device),
    }


def init_rglru_model(cfg, gen: torch.Generator, device="cpu"):
    """Parameters drawn from ``gen`` (a generator on ``device``).  The
    numbers differ from the reference's ``jax.random`` ones; the tree, the
    shapes and the scales are the same."""
    kinds = _layer_kinds(cfg)
    n_rec = sum(k == "rec" for k in kinds)
    n_att = max(sum(k == "attn" for k in kinds), 1)
    return {
        "embed": L.init_embedding(gen, cfg.vocab_padded, cfg.d_model, device),
        "rec": L.init_stacked(lambda: init_rec_layer(cfg, gen, device),
                              n_rec),
        "att": L.init_stacked(
            lambda: {"ln": L.init_rmsnorm(cfg.d_model, device),
                     "attn": L.init_attention(gen, attn_cfg(cfg), device)},
            n_att),
        "mlp": L.init_stacked(
            lambda: {"ln": L.init_rmsnorm(cfg.d_model, device),
                     "mlp": L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff,
                                           device)},
            cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _combine(a1, b1, a2, b2):
    """The scan's operator on ``(a, b)`` pairs: ``h -> a2 (a1 h + b1) + b2``."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """``even[0], odd[0], even[1], ...`` along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], 2).flatten(1, 2)
    return out if even.shape[1] == n else torch.cat([out, even[:, n:]], 1)


def _associative_scan(a, b):
    """Inclusive scan of :func:`_combine` along dim 1 by
    ``jax.lax.associative_scan``'s odd/even recursion: combine adjacent
    pairs, scan those (half the length), then fill in the even positions;
    about 2 log2(S) levels, and under autograd about twice the inputs'
    memory."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                         a[:, 1::2], b[:, 1::2]))
    tail = slice(None, -1) if n % 2 == 0 else slice(None)
    ea, eb = _combine(oa[:, tail], ob[:, tail], a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rg_lru_scan(a, bx, h0=None):
    """``h_t = a_t * h_{t-1} + bx_t`` over dim 1 (the sequence), the
    reference's associative scan, with ``h0`` folded into ``bx[:, 0]``.
    a, bx: (B, S, W); h0: (B, W) or None.  Returns h (B, S, W)."""
    if h0 is not None:
        bx = torch.cat([(bx[:, 0] + a[:, 0] * h0)[:, None], bx[:, 1:]], 1)
    return _associative_scan(a, bx)[1]


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------

def _gate_logits(cf, w, bias):
    """``cf @ w + bias`` in f32.  On DTensors the product is a partial sum
    over ``model`` (it contracts the lanes split there), reduce-scattered
    over the lanes before the split bias is added, as torch 2.13's add
    does by itself: torch 2.11's add would turn the bias into a partial
    sum instead, which it does not support.  (The convolution's bias
    meets its sum the same way.)"""
    return L.head_hint(torch.einsum("bsw,wv->bsv", cf, w.float()), 2) + bias


def rec_block(cfg, lp, x, *, state=None, conv_buf=None, plain=False):
    """Griffin recurrent block.  Returns ``(out, new_state, new_conv_tail)``;
    one token with a state is a plain decode step, anything else runs the
    scan (from ``state``, or zeros): the kernel on CUDA tensors, or, with
    ``plain`` (training, under autograd) or on another device, the
    reference's associative scan.  On DTensors the scan runs on each
    rank's rows."""
    h = L.rmsnorm(lp["ln"], x)
    dt = h.dtype
    gate = F.gelu(torch.einsum("bsd,dw->bsw", h, lp["w_gate"].to(dt)),
                  approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", h, lp["w_rec"].to(dt))

    cw, s = cfg.conv_width, u.shape[1]
    if conv_buf is not None:
        ctx = torch.cat([conv_buf.to(u.dtype), u], dim=1)
    else:       # zeros before the first step (a concatenation, as
        # rwkv6.py::_shifted explains)
        ctx = torch.cat([torch.zeros_like(u[:, :1])] * (cw - 1) + [u], 1)
    conv = ctx[:, :s] * lp["conv_w"][cw - 1].to(u.dtype)
    for j in range(1, cw):
        conv = conv + ctx[:, j:j + s] * lp["conv_w"][cw - 1 - j].to(u.dtype)
    conv = L.head_hint(conv, 2) + lp["conv_b"].to(u.dtype)
    new_conv_tail = ctx[:, ctx.shape[1] - (cw - 1):].clone()

    cf = conv.float()
    r = torch.sigmoid(_gate_logits(cf, lp["wa"], lp["ba"]))
    i = torch.sigmoid(_gate_logits(cf, lp["wi"], lp["bi"]))
    log_a = -C_RGLRU * F.softplus(lp["lam"]) * r         # <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bx = mult * (i * cf)

    if s == 1 and state is not None:                     # decode: one step
        hs = (a[:, 0] * state + bx[:, 0])[:, None]
        new_state = hs[:, 0]
    elif plain or a.device.type != "cuda":
        hs = L.local_rows(rg_lru_scan, a, bx, state)
        new_state = hs[:, -1]
    else:
        hs, new_state = L.local_rows(lru_scan, a, bx, state)
    out = torch.einsum("bsw,wd->bsd", gate * hs.to(gate.dtype),
                       lp["wo"].to(gate.dtype))
    return out, new_state, new_conv_tail


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _ring(k, positions, wnd):
    """(B, S, KV, hd) fresh keys at the consecutive ``positions`` -> the
    (B, wnd, KV, hd) ring buffer of the last ``min(wnd, S)`` of them, slot
    = position % wnd, the other slots zero.  A rotation by concatenation,
    not an indexed write: torch 2.11 has no DTensor rule for
    ``index_put_``."""
    take = min(wnd, k.shape[1])
    buf = k[:, -take:]
    if take < wnd:
        buf = torch.cat([buf, k.new_zeros((k.shape[0], wnd - take)
                                          + tuple(k.shape[2:]))], 1)
    t = int(positions[-take]) % wnd        # the oldest kept key's slot
    return torch.cat([buf[:, wnd - t:], buf[:, :wnd - t]], 1) if t else buf


def _att_block(cfg, ap, x, positions, fresh):
    """A local-attention layer over fresh keys: ``(out, (k, v))``."""
    return L.attention(ap["attn"], attn_cfg(cfg), L.rmsnorm(ap["ln"], x),
                       positions, fresh=fresh, q_block=cfg.q_block,
                       kv_block=cfg.kv_block)


def _mlp_block(cfg, lm, x):
    return x + L.glu_mlp(lm["mlp"], L.rmsnorm(lm["ln"], x), cfg.mlp_kind)


def forward(cfg, params, tokens, *, caches=None, cache_len=None,
            collect=False, last_only=False, return_hidden=False):
    """Returns ``(logits, caches)`` (the final-normed hidden states in
    place of the logits with ``return_hidden``).

    caches: the decode state (see :func:`init_cache`), updated in place.
    ``collect=True`` (a prefill): build fresh caches from a full pass, on
    CUDA tensors its scans through the RG-LRU kernel and its attention
    through the flash attention kernel.  Neither (training, as the
    reference's loss): no cache is built (``caches`` comes back None), the
    scans run the reference's associative scan and attention the
    blockwise ``sdpa`` (the flash backward has no head dim 256), under
    autograd."""
    kinds = _layer_kinds(cfg)
    acfg = attn_cfg(cfg)
    x = L.embed(params["embed"], tokens, dtype=cfg.act_dtype)
    s = tokens.shape[1]
    base = 0 if cache_len is None else cache_len
    positions = base + torch.arange(s, device=tokens.device)
    wnd = cfg.window or s

    decode_mode = caches is not None
    plain = not (decode_mode or collect)
    if decode_mode:
        write_idx = cache_len % wnd
        caches["kv_pos"][write_idx] = cache_len
    out_caches = {"kv_k": [], "kv_v": [], "state": [], "conv": []}

    rec, att = _unbind(params["rec"]), _unbind(params["att"])
    mlp = _unbind(params["mlp"])
    ri, ai = 0, 0
    for li, kind in enumerate(kinds):
        if kind == "rec":
            state = caches["state"][ri] if decode_mode else None
            buf = caches["conv"][ri] if decode_mode else None
            o, new_state, new_buf = L.remat(cfg, rec_block, cfg, rec[ri], x,
                                            state=state, conv_buf=buf,
                                            plain=plain)
            x = x + o
            if decode_mode:
                caches["state"][ri] = new_state
                caches["conv"][ri] = new_buf
            elif collect:
                out_caches["state"].append(new_state)
                out_caches["conv"].append(new_buf)
            ri += 1
        else:
            ap = att[ai]
            if decode_mode:
                o, _ = L.attention(
                    ap["attn"], acfg, L.rmsnorm(ap["ln"], x), positions,
                    kv_cache=(caches["kv_k"][ai], caches["kv_v"][ai]),
                    cache_len=cache_len, cache_write_idx=write_idx,
                    cache_positions=caches["kv_pos"], q_block=cfg.q_block,
                    kv_block=cfg.kv_block)
            else:
                o, (k, v) = L.remat(cfg, _att_block, cfg, ap, x, positions,
                                    collect)
                if collect:
                    out_caches["kv_k"].append(_ring(k, positions, wnd))
                    out_caches["kv_v"].append(_ring(v, positions, wnd))
            x = x + o
            ai += 1
        x = L.remat(cfg, _mlp_block, cfg, mlp[li], x)

    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params["final_norm"], x)
    logits = x if return_hidden else L.unembed(params["embed"], x, cfg.vocab)

    if decode_mode:
        return logits, caches
    if not collect:
        return logits, None
    new_caches = {k: (torch.stack(v) if v else torch.zeros((0,),
                                                           device=x.device))
                  for k, v in out_caches.items()}
    take = min(wnd, s)
    kv_pos = torch.full((wnd,), SENTINEL, dtype=torch.int32, device=x.device)
    kv_pos[positions[-take:] % wnd] = positions[-take:].to(torch.int32)
    new_caches["kv_pos"] = kv_pos
    return logits, new_caches


def loss_fn(cfg, params, batch):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1): the cache-free
    training forward, through the blockwise attention and the associative
    scan."""
    tokens = batch["tokens"]
    hidden, _ = forward(cfg, params, tokens[:, :-1], return_hidden=True)
    loss = L.chunked_unembed_xent(params["embed"], hidden, tokens[:, 1:],
                                  cfg.vocab)
    return loss, {"xent": loss}


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu"):
    """Zeroed decode state, keyed, shaped and typed as the reference's."""
    kinds = _layer_kinds(cfg)
    n_rec = sum(k == "rec" for k in kinds)
    n_att = sum(k == "attn" for k in kinds)
    w = _lru_width(cfg)
    wnd = min(cfg.window or max_len, max_len)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "kv_k": zeros((n_att, batch, wnd, cfg.n_kv, cfg.head_dim_), dtype),
        "kv_v": zeros((n_att, batch, wnd, cfg.n_kv, cfg.head_dim_), dtype),
        "state": zeros((n_rec, batch, w), torch.float32),
        "conv": zeros((n_rec, batch, cfg.conv_width - 1, w), dtype),
        "kv_pos": torch.full((wnd,), SENTINEL, dtype=torch.int32,
                             device=device),
    }


def prefill(cfg, params, tokens):
    """Run the prompt; returns the last position's logits (B, vocab_padded)
    and fresh caches."""
    logits, caches = forward(cfg, params, tokens, collect=True,
                             last_only=True)
    return logits[:, -1], caches


def decode_step(cfg, params, caches, tokens, cache_len):
    """One-token decode: tokens (B, 1) at position ``cache_len``.  The
    caches are updated in place and returned."""
    logits, caches = forward(cfg, params, tokens, caches=caches,
                             cache_len=cache_len)
    return logits[:, -1], caches
