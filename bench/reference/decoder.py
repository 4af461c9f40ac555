"""The plain reference of the decoder-only LM cells (the ``lm`` and ``moe``
families): a Llama-style decoder (SmolLM) and the OLMoE block, written
from their published descriptions and the configuration file as it is
run, in plain PyTorch, f32 with TF32 off.  It imports nothing of the
program and takes nothing the program made: the weights and the tokens
are the benchmark's own (:mod:`weights`), in the program's parameter
layout (the layers stacked on a leading dimension).

What the file states and the model follows: pre-norm blocks, RMSNorm
(``rms_norm_eps``), rotary embeddings on the two halves of each head,
grouped-query attention (query head h reads key/value head h // (H /
KV)), a causal softmax, the head-wise q/k RMSNorm (``qk_norm``), a SwiGLU
MLP, or a routed-expert layer: a softmax router over ``num_experts``, the
top ``num_experts_per_tok`` gates (renormalised where
``norm_topk_prob``), tokens taken in groups of ``moe_group_size`` along
the sequence, each expert taking at most ``capacity`` (token, choice)
pairs of a group in (token, choice) order and dropping the rest, the
load-balance and router-z losses weighted by ``router_aux_loss_coef`` and
``router_z_loss_coef``; tied input and output embeddings over the real
vocabulary; a mean token cross-entropy plus ``z_loss`` times the squared
log-partition.  AdamW with global-norm clipping as the traffic's
``optimizer`` states it.

``precision="fp8"`` is the control: every matrix product's operands, in
the forward and the backward, rounded to float8 e4m3 with one scale a
tensor (its absolute maximum to 448), the step below the bf16 the
configuration states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _fq(x):
    """``x`` rounded through float8 e4m3, one scale for the tensor."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fq(a), _fq(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fq(g)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def matmul_for(precision: str):
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"precision {precision!r}")


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (b, s, heads, hd), positions 0..s-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (torch.arange(s, device=x.device, dtype=torch.float32)[:, None]
           * inv.float())[:, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(c, lw, i, x, mm):
    b, s, d = x.shape
    heads, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // heads
    eps = c["rms_norm_eps"]
    a = lw["attn"]
    q = mm(x, a["wq"][i].reshape(d, heads * hd)).view(b, s, heads, hd)
    k = mm(x, a["wk"][i].reshape(d, kv * hd)).view(b, s, kv, hd)
    v = mm(x, a["wv"][i].reshape(d, kv * hd)).view(b, s, kv, hd)
    if c.get("qk_norm"):
        q = rms(q, a["q_norm"][i], eps)
        k = rms(k, a["k_norm"][i], eps)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    g = heads // kv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (b, h, s, hd)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = mm(p, v).transpose(1, 2).reshape(b, s, heads * hd)
    return mm(o, a["wo"][i].reshape(heads * hd, d))


def capacity(c, g: int) -> int:
    cap = math.ceil(g * c["num_experts_per_tok"] / c["num_experts"]
                    * c["moe_capacity_factor"])
    return max(4, -(-cap // 4) * 4)


def moe(c, lw, i, x, mm, routes=None):
    """The routed-expert layer: ``(out, load balance, router z)``;
    appends the chosen experts ``(tokens, k)`` to ``routes`` if given."""
    b, s, d = x.shape
    m = lw["moe"]
    n, k = c["num_experts"], c["num_experts_per_tok"]
    e_all = m["router"].shape[-1]
    g = min(c["moe_group_size"], s)
    s_pad = -(-s // g) * g
    xp = F.pad(x, (0, 0, 0, s_pad - s)) if s_pad != s else x
    groups = b * s_pad // g
    xg = xp.reshape(groups, g, d)
    logits = mm(xg, m["router"][i])                        # (G, g, E)
    if e_all != n:
        logits = logits.masked_fill(
            torch.arange(e_all, device=x.device) >= n, -1e30)
    probs = torch.softmax(logits, -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], idx[..., :k]
    if routes is not None:
        routes.append(idx.reshape(-1, k).detach())
    if c.get("norm_topk_prob"):
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    cap = capacity(c, g)
    flat = idx.reshape(groups, g * k)                      # (token, choice)
    hot = F.one_hot(flat, e_all)
    pos = torch.gather(hot.cumsum(1), 2, flat[..., None])[..., 0]
    keep = pos <= cap
    rows = xg.reshape(groups * g, d)
    token = (torch.arange(groups, device=x.device)[:, None] * g
             + torch.arange(g * k, device=x.device)[None, :] // k)
    gate_flat = gates.reshape(groups, g * k)
    out = torch.zeros_like(rows)
    for e in range(n):
        sel = (flat == e) & keep
        if not bool(sel.any()):
            continue
        tok, gate = token[sel], gate_flat[sel]
        xe = rows[tok]
        h = F.silu(mm(xe, m["wi_gate"][i][e])) * mm(xe, m["wi_up"][i][e])
        out = out.index_add(0, tok, mm(h, m["wo"][i][e]) * gate[:, None])
    out = out.reshape(b, s_pad, d)[:, :s]
    me = probs[..., :n].reshape(-1, n).mean(0)
    chosen = F.one_hot(idx, e_all).sum(-2)[..., :n] > 0
    ce = chosen.reshape(-1, n).float().mean(0) * n / k
    lb = n * torch.mean(me * ce)
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    return out, lb, z


def loss_fn(c, w, tokens, precision="f32", routes=None):
    """Mean loss of ``tokens`` (b, s + 1) under weights ``w``; the routed
    experts of each layer go to ``routes`` if given."""
    mm = matmul_for(precision)
    eps = c["rms_norm_eps"]
    inp, lab = tokens[:, :-1], tokens[:, 1:]
    table = w["embed"]["table"]
    lw = w["layers"]
    x = table[inp]
    lbs, zs = [], []
    for i in range(c["num_hidden_layers"]):
        x = x + attention(c, lw, i, rms(x, lw["ln1"]["scale"][i], eps), mm)
        h = rms(x, lw["ln2"]["scale"][i], eps)
        if c.get("num_experts"):
            out, lb, z = moe(c, lw, i, h, mm, routes)
            lbs.append(lb)
            zs.append(z)
        else:
            mlp = lw["mlp"]
            out = mm(F.silu(mm(h, mlp["wi_gate"][i])) * mm(h, mlp["wi_up"][i]),
                     mlp["wo"][i])
        x = x + out
    x = rms(x, w["final_norm"]["scale"], eps)
    logits = mm(x, table.T)
    vocab = c["vocab_size"]
    if table.shape[0] != vocab:
        logits = logits.masked_fill(
            torch.arange(table.shape[0], device=x.device) >= vocab,
            float("-inf"))
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    loss = (lse - ll + c["z_loss"] * lse ** 2).mean()
    if lbs:
        loss = loss + c["router_aux_loss_coef"] * torch.stack(lbs).mean() \
            + c["router_z_loss_coef"] * torch.stack(zs).mean()
    return loss


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _lr(opt: dict, step: int) -> float:
    """The learning rate of 1-based step ``step``: linear warm-up to
    ``lr`` over ``warmup`` steps, then a cosine to zero at ``total``."""
    base, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return base * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * base * (1.0 + math.cos(math.pi * frac))


def train_steps(c, w, batch_of, n_vertices: int, steps: int, opt: dict,
                block: int, precision: str = "f32", vertices=None,
                exchange: bool = True) -> dict:
    """``steps`` data-parallel AdamW steps of the plain model from the
    weights ``w`` (changed in place), the global batch of step ``t``
    being ``batch_of(t)``, split evenly over ``n_vertices`` vertices in
    order.  Each vertex's loss is the mean over its rows, computed in
    blocks of ``block`` rows (a dense model's mean over blocks is the
    mean over the rows; a routed model's balance loss is not, so give it
    the vertex's whole batch); the gradient is the mean over the
    vertices.  ``vertices`` (default all) and ``exchange=False`` (each
    vertex keeps its own gradient: vertex 0's over ``n_vertices``) plant
    the faults the calibration reads.

    Returns the loss and the global gradient norm (before clipping) of
    each step, the norms of the clipped first gradient by leaf, and the
    experts the first step's forward routed each (token, choice) to, a
    ``(tokens, k)`` tensor a vertex and layer in that order."""
    routes = []
    items = _leaves(w)
    params = [p for _, p in items]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    vertices = list(range(n_vertices)) if vertices is None else vertices
    losses, gnorms, first = [], [], None
    for t in range(steps):
        toks = batch_of(t)
        per = toks.shape[0] // n_vertices
        grads = [torch.zeros_like(p) for p in params]
        total = 0.0
        for v in vertices:
            part = toks[v * per:(v + 1) * per]
            for r in range(0, per, block):
                blk = part[r:r + block]
                share = blk.shape[0] / per
                if not exchange and v:      # its gradient is never used
                    with torch.no_grad():
                        total += float(loss_fn(c, w, blk, precision,
                                               routes if t == 0 else None)
                                       ) * share
                    continue
                for p in params:
                    p.requires_grad_(True)
                loss = loss_fn(c, w, blk, precision,
                               routes if t == 0 else None)
                gs = torch.autograd.grad(loss, params)
                for acc, g in zip(grads, gs):
                    acc.add_(g, alpha=share)
                total += float(loss.detach()) * share
                del loss, gs
        for p in params:
            p.requires_grad_(False)
        for acc in grads:
            acc.div_(len(vertices) if exchange else n_vertices)
        losses.append(total / len(vertices))
        gn = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        gnorms.append(gn)
        scale = min(1.0, opt["clip_norm"] / (gn + 1e-9))
        for g in grads:
            g.mul_(scale)
        if t == 0:
            first = {path: float(torch.linalg.vector_norm(g.double()))
                     for (path, _), g in zip(items, grads)}
        step = t + 1
        lr = _lr(opt, step)
        b1, b2 = opt["b1"], opt["b2"]
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m / c1) / (torch.sqrt(v / c2) + opt["eps"])
                decay = opt["weight_decay"] if p.dim() >= 2 else 0.0
                p.sub_(lr * (delta + decay * p))
        del grads
    return {"loss": losses, "grad_norm": gnorms, "first_grad": first,
            "routes": routes}
