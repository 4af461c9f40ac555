"""Plain PyTorch version of the WKV6 kernel.

The function of the reference's ``repro/kernels/wkv6`` (kernel and
oracle), a port of ``repro/models/rwkv6.py::wkv6_chunked``: the sequence
is cut into chunks of ``c = min(chunk, T)`` steps, zero-padded at the
tail with ``logw = 0`` (no decay), and each chunk is four small products
around a per-channel cumulative log-decay ``L``:

    scores[t, i] = (r_t exp(L_{t-1} - mx)) . (k_i exp(mx - L_i)),  i < t
    o_t = sum_i scores[t, i] v_i + (r_t u k_t) v_t + (r_t exp(L_{t-1})) S
    S'  = diag(exp(L_C)) S + sum_i (k_i exp(L_C - L_i)) v_i^T

with ``mx = max_t(-L_t)`` shifting both factors of a score and each
clamped to [-85, 85], as the reference clamps them.  Every chunk's own
terms are computed for all chunks at once, and only the state runs chunk
by chunk (two ops a chunk), each element with the arithmetic of one
chunk at a time.  Arithmetic is f32; ``out`` comes back in ``r``'s dtype
and the state in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CLAMP = 85.0


def wkv6_ref(r, k, v, logw, u, s0=None, chunk=64):
    """r, k, v, logw: (B, T, H, N) (logw the log decay, <= 0); u: (H, N);
    s0: (B, H, N, N) f32 or None (zeros).  Returns ``(out (B, T, H, N),
    final state (B, H, N, N))``, the state's rows the key dimension."""
    b, t, h, n = r.shape
    c = min(chunk, t)
    t_pad = -(-t // c) * c
    if t_pad != t:
        pad = (0, 0, 0, 0, 0, t_pad - t)
        r, k, v, logw = (F.pad(x, pad) for x in (r, k, v, logw))
    nc = t_pad // c

    def chunks(x):                                  # (nc, B, H, C, N) f32
        return x.float().reshape(b, nc, c, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunks, (r, k, v, logw))
    lcum = wc.cumsum(3)                            # L_t (inclusive)
    lprev = lcum - wc                              # L_{t-1}
    mx = (-lcum).amax(3, keepdim=True)
    kd = kc * torch.exp(torch.clamp(-lcum + mx, -CLAMP, CLAMP))
    rd = rc * torch.exp(torch.clamp(lprev - mx, -CLAMP, CLAMP))
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(tri, torch.einsum("cbhtn,cbhin->cbhti", rd, kd),
                         0.0)
    diag = torch.einsum("cbhtn,hn,cbhtn->cbht", rc, u.float(), kc)
    o = torch.einsum("cbhti,cbhin->cbhtn", scores, vc)
    o = o + diag[..., None] * vc
    lc = lcum[:, :, :, -1:, :]                     # (nc, B, H, 1, N)
    decay = torch.exp(lc.squeeze(3))[..., None]
    inc = torch.einsum("cbhin,cbhim->cbhnm", kc * torch.exp(lc - lcum), vc)
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device) \
        if s0 is None else s0
    before = []                                    # the state entering each
    for i in range(nc):
        before.append(s)
        s = decay[i] * s + inc[i]
    o = o + torch.einsum("cbhtn,cbhnm->cbhtm", rc * torch.exp(lprev),
                         torch.stack(before))
    out = o.permute(1, 0, 3, 2, 4).reshape(b, t_pad, h, n)
    return out[:, :t].to(r.dtype), s
