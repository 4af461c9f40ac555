"""Mixture-of-Experts layer (the ``moe`` family: OLMoE, Qwen2-MoE), the
reference's ``repro/models/moe.py``.

GShard grouped dispatch: tokens go in groups of ``group_size``; each group
dispatches to per-expert capacity slots through one-hot products, and a
(token, choice) past its expert's capacity is dropped.  The router takes
the top k of an f32 softmax (padded experts masked to ``-1e30``), with
optional renormalisation, and gives the load-balance and router-z
auxiliary losses.  Shared experts (Qwen2-MoE) are an always-on gated MLP
with a sigmoid gate.  The reference computes all of this as einsums
outside any kernel, and so does the port; its sharding hints have no
counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .layers import batch_hint, ninit


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    n_experts: int            # real expert count (router range)
    n_experts_padded: int     # padded for expert-parallel divisibility
    top_k: int
    d_expert: int             # per-expert ffn width
    n_shared: int = 0         # always-on shared experts (width n_shared*d_expert)
    group_size: int = 512
    capacity_factor: float = 1.0
    renorm: bool = True       # renormalise the top-k gates


def init_moe(gen, cfg: MoECfg, device="cpu"):
    """The reference's tree, shapes and scales; the numbers are drawn from
    ``gen`` one leaf after another (the reference draws the shared
    ``wi_gate`` and ``wi_up`` from one key, the port draws each)."""
    e, d, f = cfg.n_experts_padded, cfg.d_model, cfg.d_expert

    def n(shape, scale=None):
        return ninit(gen, shape, scale=scale, device=device)

    p = {"router": n((d, e), 0.02), "wi_gate": n((e, d, f)),
         "wi_up": n((e, d, f)), "wo": n((e, f, d))}
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared"] = {"wi_gate": n((d, fs)), "wi_up": n((d, fs)),
                       "wo": n((fs, d)), "gate": n((d, 1), 0.02)}
    return p


def route(p, cfg: MoECfg, xg):
    """Router of grouped tokens xg (B, NG, G, d): ``(logits, probs,
    gate_vals, gate_idx)``, the f32 logits and probabilities (B, NG, G, E)
    and the top-k gates and experts (B, NG, G, k).  Equal probabilities
    rank by expert index, lowest first, as ``jax.lax.top_k`` ranks them
    (the zero tokens that pad the last group have all-equal logits)."""
    e = cfg.n_experts_padded
    logits = torch.einsum("bgtd,de->bgte", xg, p["router"].to(xg.dtype))
    logits = logits.float()
    if cfg.n_experts != e:   # mask padded experts
        real = torch.arange(e, device=xg.device) < cfg.n_experts
        logits = torch.where(real, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    if cfg.renorm:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return logits, probs, gate_vals, gate_idx


def capacity(cfg: MoECfg, g: int) -> int:
    """Slots per expert and group of ``g`` tokens: ``g k / n_experts``
    (the real count) times the capacity factor, rounded up to a multiple
    of 4, at least 4."""
    cap = int(np.ceil(g * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-cap // 4) * 4)


def moe_layer(p, cfg: MoECfg, x):
    """x: (B, S, d) -> (out (B, S, d), aux losses dict)."""
    x = batch_hint(x)     # on DTensors: the sequence whole for the groups
    b, s, d = x.shape
    e, k, dt = cfg.n_experts_padded, cfg.top_k, x.dtype
    g = min(cfg.group_size, s)
    s_pad = -(-s // g) * g
    x_r = F.pad(x, (0, 0, 0, s_pad - s)) if s_pad != s else x
    ng = s_pad // g
    xg = x_r.reshape(b, ng, g, d)

    logits, probs, gate_vals, gate_idx = route(p, cfg, xg)
    cap = capacity(cfg, g)

    # position of each (token, choice) in its expert's capacity buffer:
    # a cumsum over the flattened (token, choice) order per expert
    onehot = F.one_hot(gate_idx, e)                           # (b,ng,g,k,e)
    flat = onehot.reshape(b, ng, g * k, e)
    pos = (torch.cumsum(flat, dim=2) * flat).reshape(b, ng, g, k, e)
    pos_tk = pos.sum(-1)                                      # 1-indexed
    keep = (pos_tk > 0) & (pos_tk <= cap)
    slot_tk = torch.clamp(pos_tk - 1, 0, cap - 1)

    # dispatch / combine (b,ng,g,e,cap) from two one-hots contracted over k
    oh_e = onehot.to(dt)
    oh_c = F.one_hot(slot_tk, cap).to(dt) * keep[..., None].to(dt)
    dispatch = batch_hint(torch.einsum("bgtke,bgtkc->bgtec", oh_e, oh_c))
    combine = batch_hint(torch.einsum(
        "bgtke,bgtkc->bgtec", oh_e * gate_vals[..., None].to(dt), oh_c))

    xin = torch.einsum("bgtec,bgtd->bgecd", dispatch, xg)
    h_g = torch.einsum("bgecd,edf->bgecf", xin, p["wi_gate"].to(dt))
    h_u = torch.einsum("bgecd,edf->bgecf", xin, p["wi_up"].to(dt))
    xout = torch.einsum("bgecf,efd->bgecd", F.silu(h_g) * h_u,
                        p["wo"].to(dt))
    out = torch.einsum("bgtec,bgecd->bgtd", combine, xout)
    out = out.reshape(b, s_pad, d)[:, :s]

    # aux losses (over the real experts only)
    n = cfg.n_experts
    me = probs[..., :n].mean(dim=(0, 1, 2))
    ce = (onehot.sum(3)[..., :n] > 0).float().mean(dim=(0, 1, 2)) * n / k
    aux = {"moe_load_balance": n * torch.mean(me * ce),
           "moe_router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}

    if cfg.n_shared:
        sp = p["shared"]
        sg = F.silu(torch.einsum("bsd,df->bsf", x, sp["wi_gate"].to(dt)))
        su = torch.einsum("bsd,df->bsf", x, sp["wi_up"].to(dt))
        sh = torch.einsum("bsf,fd->bsd", sg * su, sp["wo"].to(dt))
        gate = torch.sigmoid(torch.einsum("bsd,dz->bsz", x,
                                          sp["gate"].to(dt)))
        out = out + gate * sh
    return out, aux
