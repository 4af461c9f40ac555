"""RWKV-6 "Finch" (``rwkv6`` family, the reference's
``repro/models/rwkv6.py``), for serving and its loss [arXiv:2404.05892].

Time-mix: token-shift ddlerp (5 streams r, k, v, w, g with a shared
low-rank data-dependent adjustment), per-channel data-dependent decay
``w_t = exp(-exp(w0 + LoRA_w(x)))`` and bonus ``u``, and the WKV state
recurrence

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T);   S_t = diag(w_t) S_{t-1} + k_t v_t^T

which a prefill runs through the WKV6 kernel (the chunked algorithm) and
decode as one plain step (:func:`wkv6_step`).  Channel-mix: squared-relu
MLP with a receptance gate.

Layer parameters are stacked along a leading ``layers`` dimension, as the
reference stacks them for its ``scan``; the forward unbinds them once and
loops.  Decode state, keyed and shaped as the reference's: per layer the
WKV state (f32), and the last token of each mix's normed input.  Decode
updates the caches in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.wkv6.ops import wkv
from ..kernels.wkv6.ref import wkv6_ref
from . import layers as L
from .transformer import _unbind

LORA_R = 32      # low-rank width of the ddlerp / decay adapters
N_STREAMS = 5    # r, k, v, w, g


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg, gen, device="cpu"):
    d = cfg.d_model
    h = d // cfg.head_size

    def n(shape, scale=None):
        return L.ninit(gen, shape, scale=scale, device=device)

    return {
        "ln1": L.init_layernorm(d, device),
        "ln2": L.init_layernorm(d, device),
        # ddlerp token-shift mixing
        "mu_x": L.zinit((d,), device), "mu": L.zinit((N_STREAMS, d), device),
        "tm_w1": n((d, N_STREAMS * LORA_R), 0.01),
        "tm_w2": n((N_STREAMS, LORA_R, d), 0.01),
        # projections
        "wr": n((d, d)), "wk": n((d, d)), "wv": n((d, d)), "wg": n((d, d)),
        "wo": n((d, d)),
        # decay: w0 + lora
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "dw1": n((d, 64), 0.01),
        "dw2": n((64, d), 0.01),
        "u": n((h, cfg.head_size), 0.5),
        "ln_x": torch.ones((d,), dtype=torch.float32, device=device),
        # channel mix
        "cm_mu_k": L.zinit((d,), device), "cm_mu_r": L.zinit((d,), device),
        "cm_wk": n((d, cfg.d_ff)),
        "cm_wv": n((cfg.d_ff, d)),
        "cm_wr": n((d, d)),
    }


def init_rwkv6_model(cfg, gen: torch.Generator, device="cpu"):
    """Parameters drawn from ``gen`` (a generator on ``device``).  The
    numbers differ from the reference's ``jax.random`` ones; the tree, the
    shapes and the scales are the same."""
    embed = L.init_embedding(gen, cfg.vocab_padded, cfg.d_model, device)
    return {"embed": embed,
            "layers": L.init_stacked(lambda: init_layer(cfg, gen, device),
                                     cfg.n_layers),
            "final_norm": L.init_layernorm(cfg.d_model, device)}


# ---------------------------------------------------------------------------
# WKV6 one-token step (decode); the chunked prefill is kernels/wkv6
# ---------------------------------------------------------------------------

def wkv6_step(r, k, v, logw, u, s):
    """Single-token exact recurrence.  r, k, v, logw: (B, H, N); s:
    (B, H, N, N) f32.  Returns ``(o (B, H, N) in r's dtype, new state)``."""
    r32, k32, v32 = (x.float() for x in (r, k, v))
    kv = torch.einsum("bhn,bhm->bhnm", k32, v32)
    o = torch.einsum("bhn,bhnm->bhm", r32, s + u.float()[..., None] * kv)
    s_new = torch.exp(logw.float())[..., None] * s + kv
    return o.to(r.dtype), s_new


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _shifted(xn, last):
    """The previous token of every position: ``last`` (B, d) before the
    first, zeros when there is none."""
    first = torch.zeros_like(xn[:, :1]) if last is None \
        else last[:, None, :].to(xn.dtype)
    if xn.shape[1] == 1:
        return first
    # a concatenation, not a pad: a DTensor padded so failed the next op's
    # sharding propagation on torch 2.11 (the card's)
    return torch.cat([first, xn[:, :-1]], 1)


def _ddlerp(p, x, sx):
    """5-stream token-shift mixing.  x, sx: (B, S, d) -> 5 mixed."""
    dt = x.dtype
    base = x + sx * p["mu_x"].to(dt)
    lora = torch.einsum("bsd,dr->bsr", torch.tanh(base), p["tm_w1"].to(dt))
    lora = lora.reshape(*lora.shape[:-1], N_STREAMS, LORA_R)
    adj = torch.einsum("bszr,zrd->bszd", lora, p["tm_w2"].to(dt))
    mixed = x[..., None, :] + sx[..., None, :] * (p["mu"].to(dt) + adj)
    return mixed.unbind(-2)


def time_mix(cfg, p, x, *, state=None, last=None, plain=False):
    """state: (B, H, N, N) WKV state; last: (B, d) previous token (decode).
    Returns ``(out, new_state, new_last)``; one token with a state is a
    plain decode step, anything else runs the WKV6 kernel (from
    ``state``, or zeros), or with ``plain`` (the loss, under autograd) its
    plain chunked version."""
    b, s, d = x.shape
    h, n = cfg.n_heads, cfg.head_size
    dt = x.dtype
    xn = L.layernorm(p["ln1"], x)
    sx = _shifted(xn, last) - xn
    xr, xk, xv, xw, xg = _ddlerp(p, xn, sx)

    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(dt))
    k = torch.einsum("bsd,de->bse", xk, p["wk"].to(dt))
    v = torch.einsum("bsd,de->bse", xv, p["wv"].to(dt))
    g = torch.einsum("bsd,de->bse", xg, p["wg"].to(dt))
    dlora = torch.einsum("bsd,dr->bsr", torch.tanh(xw.float()),
                         p["dw1"].float())
    logw = -torch.exp(p["w0"] + torch.einsum("bsr,rd->bsd", dlora,
                                             p["dw2"].float()))
    rh, kh, vh, wh = (x_.reshape(b, s, h, n) for x_ in (r, k, v, logw))

    if s == 1 and state is not None:
        o, new_state = wkv6_step(rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0],
                                 p["u"], state)
        o = o[:, None]
    else:       # on DTensors, on each rank's rows with the heads whole
        o, new_state = L.local_rows(wkv6_ref if plain else wkv, rh, kh, vh,
                                    wh, p["u"], state, whole=(4,))
    # per-head group norm, then the gate
    o32 = o.float()
    o32 = o32 * torch.rsqrt((o32 * o32).mean(-1, keepdim=True) + 1e-6)
    o = (o32.reshape(b, s, d) * p["ln_x"]).to(dt)
    o = o * F.silu(g)
    out = torch.einsum("bsd,de->bse", o, p["wo"].to(dt))
    return out, new_state, xn[:, -1].clone()


def channel_mix(p, x, *, last=None):
    dt = x.dtype
    xn = L.layernorm(p["ln2"], x)
    sx = _shifted(xn, last) - xn
    xk = xn + sx * p["cm_mu_k"].to(dt)
    xr = xn + sx * p["cm_mu_r"].to(dt)
    hidden = torch.einsum("bsd,df->bsf", xk, p["cm_wk"].to(dt))
    hidden = torch.square(F.relu(hidden))
    out = torch.einsum("bsf,fd->bsd", hidden, p["cm_wv"].to(dt))
    rgate = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["cm_wr"].to(dt)))
    return rgate * out, xn[:, -1].clone()


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _layer(cfg, lp, x, state, last_tm, last_cm, plain):
    """One layer, time mix then channel mix: ``(x, new_state, new_last_tm,
    new_last_cm)``."""
    o, new_state, new_l1 = time_mix(cfg, lp, x, state=state, last=last_tm,
                                    plain=plain)
    x = x + o
    o2, new_l2 = channel_mix(lp, x, last=last_cm)
    return x + o2, new_state, new_l1, new_l2


def forward(cfg, params, tokens, *, caches=None, last_only=False,
            return_hidden=False, plain=False):
    """Returns ``(logits, caches)`` (the final-normed hidden states in
    place of the logits with ``return_hidden``; ``plain`` as in
    :func:`time_mix`).

    caches: the decode state (see :func:`init_cache`), updated in place.
    Without caches the call is a prefill: it builds fresh caches (each
    layer's final WKV state and last normed tokens, in the activation
    dtype as the reference's scan returns them), and its WKV runs through
    the kernel."""
    x = L.embed(params["embed"], tokens, dtype=cfg.act_dtype)
    decode_mode = caches is not None
    ys = {"state": [], "last_tm": [], "last_cm": []}
    for li, lp in enumerate(_unbind(params["layers"])):
        st = caches["state"][li] if decode_mode else None
        l1 = caches["last_tm"][li] if decode_mode else None
        l2 = caches["last_cm"][li] if decode_mode else None
        x, new_state, new_l1, new_l2 = L.remat(cfg, _layer, cfg, lp, x, st,
                                               l1, l2, plain)
        if decode_mode:
            caches["state"][li] = new_state
            caches["last_tm"][li] = new_l1
            caches["last_cm"][li] = new_l2
        else:
            ys["state"].append(new_state)
            ys["last_tm"].append(new_l1)
            ys["last_cm"].append(new_l2)
    if last_only:
        x = x[:, -1:]
    x = L.layernorm(params["final_norm"], x)
    logits = x if return_hidden else L.unembed(params["embed"], x, cfg.vocab)
    if decode_mode:
        return logits, caches
    return logits, {k: torch.stack(v) for k, v in ys.items()}


def loss_fn(cfg, params, batch):
    """Next-token loss on ``batch["tokens"]`` (B, S + 1), through the
    plain chunked WKV."""
    tokens = batch["tokens"]
    hidden, _ = forward(cfg, params, tokens[:, :-1], return_hidden=True,
                        plain=True)
    loss = L.chunked_unembed_xent(params["embed"], hidden, tokens[:, 1:],
                                  cfg.vocab)
    return loss, {"xent": loss}


def init_cache(cfg, batch, max_len=None, device="cpu"):
    """Zeroed decode state, keyed, shaped and typed as the reference's
    (``max_len`` is unused: the state does not grow)."""
    h, n, d = cfg.n_heads, cfg.head_size, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"state": zeros(cfg.n_layers, batch, h, n, n),
            "last_tm": zeros(cfg.n_layers, batch, d),
            "last_cm": zeros(cfg.n_layers, batch, d)}


def prefill(cfg, params, tokens):
    """Run the prompt; returns the last position's logits (B, vocab_padded)
    and fresh caches."""
    logits, caches = forward(cfg, params, tokens, last_only=True)
    return logits[:, -1], caches


def decode_step(cfg, params, caches, tokens):
    """One-token decode: tokens (B, 1).  The caches are updated in place
    and returned."""
    logits, caches = forward(cfg, params, tokens, caches=caches)
    return logits[:, -1], caches
