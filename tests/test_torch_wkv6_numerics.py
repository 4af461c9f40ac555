"""The numerics and the fragment layouts of the WKV6 CUDA kernel, on the CPU.

The kernel (``kernels/wkv6/csrc/wkv6.cu``) runs its four products on the
tensor cores as ``mma.sync.m16n8k8`` TF32 with f32 accumulation, in the
3xTF32 form: each f32 operand is split as hi = x rounded to TF32 (10
mantissa bits, to nearest, ties away: the low 13 bits masked after adding
half their weight) and lo = x - hi, which the tensor cores truncate to
TF32, and each product is taken as lo hi + hi lo + hi hi.
:func:`kernel_emulation` repeats that arithmetic in plain PyTorch: the
per-channel decay prefix as the kernel takes it (eight segments of 8 rows,
the segments' sums scanned as the three shuffles do), the factors as
products of two exponentials an element where a channel pair's |L| stays
within 40 over the chunk and with the reference's four clamped ones
elsewhere, the score factors scaled by 2^64 and 2^-64, the 16-row tile
order with the score tiles above the diagonal skipped and the diagonal
tiles masked by a select, the two warps of a strip each summing their key
tiles and their share of the channels of ``(r e^{L_{t-1}}) S`` before the
two partial outputs are added, and the state update.  It is held against
the reference (``repro.models.rwkv6.wkv6_chunked``, the oracle of the
Pallas kernel) on the same numpy inputs, at the model's decays (0.3, -6),
the reference kernel test's (0.5, -4) and strong decays (0.5, 2) that
pass the clamp, in f32 and bf16, with and without an initial state, to
the tolerance ``chip_smoke.py::wkv_within`` holds the kernel to on the
card: 2e-4 · max(1, max|ref|), plus 2⁻⁷·|ref| for bf16 outputs.  In the
strong regime the port's side flushes subnormals, as ``test_torch_wkv6``
does: XLA's CPU backend flushes them.

Why three passes: a single TF32 pass (``passes=1``) rounds the decayed
factors, which are r and k times e^{±(up to 85)}, to 11 bits before
products summed over up to 64 channels and 128 keys and state rows.  At
the model's decays in f32, with an initial state, that misses the
tolerance on the output and on the state, where three passes take about
a thousandth of it (measured here,
``test_one_tf32_pass_misses_the_f32_tolerance``, which prints both).

The second half of the file is a numpy model of the kernel's fragment
loads: each warp's lanes read shared memory at the addresses the kernel
computes (row strides 68 and 72, 16 more bytes every 8 rows), the
``m16n8k8`` A, B and accumulator fragments are mapped to matrices by the
PTX layout, and the products of the chunk on a 64 x 64 tile are held to
plain matrix products; every fragment load of the bf16 path is checked to
fall on distinct shared-memory banks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv6_chunked
from repro_torch.kernels.wkv6.ref import CLAMP

TILE = 64                   # rows and channels of the kernel's tiles
UP, DOWN = 2.0 ** 64, 2.0 ** -64
NEAR = 40.0                 # |L| within which the factors take two expf
DECAYS = {"model": (0.3, -6.0), "reference test": (0.5, -4.0),
          "strong": (0.5, 2.0)}


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: the low 13 bits masked after adding half of their weight to the
    magnitude."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x):
    """x truncated to TF32, as the tensor cores read an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, trunc_tf32(x - hi)


def mm(a, b, passes=3):
    """a @ b as the tensor cores take it: 3xTF32 (lo hi + hi lo, summed
    apart from hi hi) or one TF32 pass; products of TF32 values are exact
    in f32, sums f32."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _prefix(w):
    """The kernel's decay prefix of one chunk tile w (..., 64, N): eight
    segments of 8 rows, each summed in order, their sums scanned as the
    three shuffles do (up by 1, 2, 4), then each segment's rows added to
    what came before.  Returns L (..., 64, N), the inclusive cumulative
    log-decay."""
    seg = w.unflatten(-2, (8, 8))                       # (..., 8, 8, N)
    s = torch.zeros_like(seg[..., 0, :])
    for i in range(8):
        s = s + seg[..., i, :]
    for d in (1, 2, 4):                                 # shuffle up by d
        x = s.clone()
        x[..., d:, :] = s[..., d:, :] + s[..., :-d, :]
        s = x
    acc = torch.zeros_like(s)
    acc[..., 1:, :] = s[..., :-1, :]                    # the segments before
    L = torch.empty_like(seg)
    for i in range(8):
        acc = acc + seg[..., i, :]
        L[..., i, :] = acc
    return L.flatten(-3, -2)


def _pad_even(x, n):
    """x (..., n) padded with a zero column to an even length."""
    return torch.nn.functional.pad(x, (0, n % 2))


def _factors(r_, k_, w_):
    """rd, kd (scaled by 2^64, 2^-64), rp, kc, e^{L_C} of one chunk tile as
    the kernel forms them."""
    L = _prefix(w_)
    lp = L - w_
    mx = (-L).amax(2, keepdim=True)
    lc = L[:, :, -1:, :]
    # the exact path: the reference's four clamped exponentials
    rd = r_ * torch.exp(torch.clamp(lp - mx, -CLAMP, CLAMP)) * UP
    kd = k_ * torch.exp(torch.clamp(-L + mx, -CLAMP, CLAMP)) * DOWN
    rp = r_ * torch.exp(lp)
    kc = k_ * torch.exp(lc - L)
    # the near path, per channel pair (n, n + 1): products of exponentials
    big = L.abs().amax(2, keepdim=True)
    n = big.shape[-1]
    pair = _pad_even(big, n).unflatten(-1, (-1, 2)).amax(-1, keepdim=True)
    near = pair.expand(*pair.shape[:-1], 2).flatten(-2)[..., :n] <= NEAR
    ke = k_ * torch.exp(-L)
    rd = torch.where(near, rp * (torch.exp(-mx) * UP), rd)
    kd = torch.where(near, ke * (torch.exp(mx) * DOWN), kd)
    kc = torch.where(near, ke * torch.exp(lc), kc)
    return rd, kd, rp, kc, torch.exp(lc.squeeze(2))


def kernel_emulation(r, k, v, logw, u, s0=None, chunk=64, passes=3):
    """(B, T, H, N) inputs as the kernel takes them -> (out in r's dtype,
    state f32), by the kernel's arithmetic (``passes=1``: one TF32 pass
    per product instead of three)."""
    b, t, h, n = r.shape
    c = min(chunk, t)

    def heads(x):                                       # (B, H, T, N) f32
        return x.float().permute(0, 2, 1, 3)

    rr, kk, vv, ww = map(heads, (r, k, v, logw))
    uf = u.float()[None, :, None, :]
    s = torch.zeros((b, h, n, n)) if s0 is None else s0.float().clone()
    out = torch.zeros((b, h, t, n))
    tri = torch.arange(16)[None, :] < torch.arange(16)[:, None]   # i < t
    for t0 in range(0, t, c):
        rows = min(c, t - t0)

        def tile(x):
            z = torch.zeros((b, h, TILE, n))
            z[:, :, :rows] = x[:, :, t0:t0 + rows]
            return z

        r_, k_, v_, w_ = map(tile, (rr, kk, vv, ww))
        rd, kd, rp, kc, ec = _factors(r_, k_, w_)
        diag = (r_ * uf * k_).sum(-1, keepdim=True)
        o = torch.zeros((b, h, TILE, n))
        for m in range(4):
            rs = slice(16 * m, 16 * m + 16)
            ks = 8 * (4 if m % 2 else 2)    # the pair's split of channels
            part = []
            for hp in range(2):                         # warps 2g, 2g + 1
                acc = torch.zeros((b, h, 16, n))
                for j in range(hp, m + 1, 2):
                    js = slice(16 * j, 16 * j + 16)
                    sc = mm(rd[:, :, rs], kd[:, :, js].transpose(-1, -2),
                            passes)
                    if j == m:
                        sc = torch.where(tri, sc, 0.0)
                    acc = acc + mm(sc, v_[:, :, js], passes)
                cs = slice(0, ks) if hp == 0 else slice(ks, TILE)
                acc = acc + mm(rp[:, :, rs, cs], s[:, :, cs], passes)
                part.append(acc)
            o[:, :, rs] = part[0] + part[1]
        o = o + diag * v_
        out[:, :, t0:t0 + rows] = o[:, :, :rows]
        s = ec[..., None] * s + mm(kc.transpose(-1, -2), v_, passes)
    return out.permute(0, 2, 1, 3).to(r.dtype), s


def _inputs(b, t, h, n, seed, decay):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(b, t, h, n).astype(np.float32) for _ in range(3))
    a, c = decay
    logw = -np.exp(a * rng.randn(b, t, h, n) + c).astype(np.float32)
    u = (0.5 * rng.randn(h, n)).astype(np.float32)
    s0 = rng.randn(b, h, n, n).astype(np.float32)
    return r, k, v, logw, u, s0


def _ratio(out, ref, dtype):
    """max over elements of |out - ref| / (2e-4 max(1, max|ref|) + rtol
    |ref|), rtol 2^-7 for bf16 outputs: at most 1 is within
    ``chip_smoke.py::wkv_within``."""
    out, ref = out.float(), torch.from_numpy(
        np.array(ref.astype(jnp.float32)))
    atol = 2e-4 * max(1.0, float(ref.abs().max()))
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


@pytest.fixture
def _flush_subnormals():
    yield torch.set_flush_denormal
    torch.set_flush_denormal(False)


def _run(regime, dtype, with_s0, passes, flush):
    b, t, h, n, c = 2, 150, 2, 64, 64
    r, k, v, logw, u, s0 = _inputs(b, t, h, n, 3 + len(regime),
                                   DECAYS[regime])
    reach = float(-np.cumsum(logw[:, :c], axis=1).min())
    assert (reach > CLAMP) == (regime == "strong")
    init = s0 if with_s0 else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jo, js = wkv6_chunked(*(jnp.asarray(x).astype(jdt) for x in (r, k, v)),
                          jnp.asarray(logw), jnp.asarray(u),
                          s0=None if init is None else jnp.asarray(init),
                          chunk=c)
    tr, tk, tv = (torch.from_numpy(x).to(dtype) for x in (r, k, v))
    flush(regime == "strong")
    out, s = kernel_emulation(tr, tk, tv, torch.from_numpy(logw),
                              torch.from_numpy(u),
                              None if init is None else torch.from_numpy(
                                  init), chunk=c, passes=passes)
    flush(False)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    return _ratio(out, jo, dtype), _ratio(s, js, torch.float32)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("regime", list(DECAYS))
def test_3xtf32_emulation_meets_the_card_tolerance(regime, dtype, with_s0,
                                                   _flush_subnormals):
    ro, rs = _run(regime, dtype, with_s0, 3, _flush_subnormals)
    print(f"3xTF32 {regime} {dtype} s0={with_s0}: share of the tolerance "
          f"out {ro!r}, state {rs!r}")
    assert ro <= 1.0 and rs <= 1.0


def test_one_tf32_pass_misses_the_f32_tolerance(_flush_subnormals):
    """The reason for three passes: one TF32 pass per product misses the
    f32 check at the model's decays, where three pass with room."""
    one = _run("model", torch.float32, True, 1, _flush_subnormals)
    three = _run("model", torch.float32, True, 3, _flush_subnormals)
    print(f"share of the f32 tolerance (out, state): one pass {one}, "
          f"three {three}")
    assert max(one) > 1.0 and max(three) < 0.1


def test_large_inputs_in_the_clamp_regime_stay_finite(_flush_subnormals):
    """r scaled by 100 and k by 4 where the clamp acts: the factors
    k e^{85} stay finite (|k| e^{85} overflows f32 above |k| = 41, in the
    reference too, so k is not scaled further), the masked products are
    dropped by the select, and the emulation meets the f32 tolerance."""
    b, t, h, n = 2, 130, 2, 64
    r, k, v, logw, u, _ = _inputs(b, t, h, n, 21, (0.5, 1.5))
    r, k = 100.0 * r, 4.0 * k
    jo, js = wkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, logw, u)))
    _flush_subnormals(True)
    out, s = kernel_emulation(*(torch.from_numpy(x)
                                for x in (r, k, v, logw, u)))
    assert bool(torch.isfinite(out).all() and torch.isfinite(s).all())
    assert _ratio(out, jo, torch.float32) <= 1.0
    assert _ratio(s, js, torch.float32) <= 1.0


def test_segmented_prefix_is_the_cumulative_sum():
    w = -torch.rand((3, 64, 5), dtype=torch.float64)
    assert torch.allclose(_prefix(w), w.cumsum(-2), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# A numpy model of the kernel's fragment loads (the products of a chunk).

LDA, LDB, LDV = 68, 72, 72              # LDV: the bf16 r, k, v tiles


def row_off(t, ld, esize=4):
    """Row t of a tile: 16 more bytes every 8 rows."""
    return t * ld + (t >> 3) * (16 // esize)


def lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3                          # gid, tig


class Smem:
    """A tile in shared memory: element (t, n) at row_off(t, ld) + n, of
    ``esize`` bytes; records the 4-byte words each warp-wide load
    touches.  ``skewed=False``: rows at t * ld (the state)."""

    def __init__(self, x, ld, esize=4, skewed=True):
        self.ld, self.esize = ld, esize
        self.off = (lambda t: row_off(t, ld, esize)) if skewed else (
            lambda t: t * ld)
        self.flat = np.zeros(self.off(TILE) + 64)
        for t in range(x.shape[0]):
            self.flat[self.off(t):self.off(t) + x.shape[1]] = x[t]
        self.loads = []

    def load(self, idx):
        """idx: (32,) element offsets of one warp-wide load."""
        self.loads.append((idx * self.esize) // 4)
        return self.flat[idx]


def conflict_free(words):
    """Each bank serves one word per load (lanes on one word share it)."""
    banks = {}
    for w in np.unique(words):
        banks.setdefault(w % 32, []).append(w)
    return all(len(v) == 1 for v in banks.values())


def mma(c, a, b):
    """c (32, 4) += the m16n8k8 product of fragments a (32, 4), b (32, 2),
    mapped to matrices by the PTX layout."""
    gid, tig = lanes()
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    A[gid, tig], A[gid + 8, tig] = a[:, 0], a[:, 1]
    A[gid, tig + 4], A[gid + 8, tig + 4] = a[:, 2], a[:, 3]
    B[tig, gid], B[tig + 4, gid] = b[:, 0], b[:, 1]
    P = A @ B
    c[:, 0] += P[gid, 2 * tig]
    c[:, 1] += P[gid, 2 * tig + 1]
    c[:, 2] += P[gid + 8, 2 * tig]
    c[:, 3] += P[gid + 8, 2 * tig + 1]


def strip(RD, KD, RP, S, V, Ob, m, hp):
    """The products of o for warp hp of strip m: its score tiles j = hp,
    hp + 2, ... <= m in one pass over the channels, each masked on the
    diagonal and times v, then its share of the channels of rp S.  Returns
    its o fragments (8, 32, 4), with the pair's other warp's part added
    for hp = 0 (``Ob`` a dict standing in for the shared partial)."""
    gid, tig = lanes()
    o = np.zeros((8, 32, 4))
    ra = row_off(16 * m + gid, LDA) + tig
    rb = row_off(16 * m + gid + 8, LDA) + tig
    js = list(range(hp, m + 1, 2))
    sc = np.zeros((len(js), 2, 32, 4))
    for kk in range(8):                   # channels past n are zero
        a = np.stack([RD.load(ra + 8 * kk), RD.load(rb + 8 * kk),
                      RD.load(ra + 8 * kk + 4), RD.load(rb + 8 * kk + 4)], 1)
        for t, j in enumerate(js):
            for q in range(2):
                pb = row_off(16 * j + 8 * q + gid, LDA) + 8 * kk + tig
                mma(sc[t, q], a, np.stack([KD.load(pb), KD.load(pb + 4)], 1))
    for t, j in enumerate(js):
        if j == m:
            row = gid[:, None] + 8 * (np.arange(4)[None, :] >> 1)
            for q in range(2):
                key = 8 * q + 2 * tig[:, None] + (np.arange(4)[None, :] & 1)
                sc[t, q] = np.where(key < row, sc[t, q], 0.0)
        for q in range(2):
            a = sc[t, q][:, [0, 2, 1, 3]]
            pv = row_off(16 * j + 8 * q + 2 * tig, V.ld, V.esize) + gid
            for nt in range(8):
                mma(o[nt], a, np.stack([V.load(pv + 8 * nt),
                                        V.load(pv + 8 * nt + V.ld)], 1))
    ks = 4 if m % 2 else 2                # the pair's split of channels
    for kk in (range(ks) if hp == 0 else range(ks, 8)):
        a = np.stack([RP.load(ra + 8 * kk), RP.load(rb + 8 * kk),
                      RP.load(ra + 8 * kk + 4), RP.load(rb + 8 * kk + 4)], 1)
        ps = (8 * kk + tig) * LDB + gid
        for nt in range(8):
            mma(o[nt], a, np.stack([S.load(ps + 8 * nt),
                                    S.load(ps + 8 * nt + 4 * LDB)], 1))
    if hp == 1:
        Ob[m] = o
        return None
    return o + Ob[m]


def state(KC, V, ms, c0):
    """kdecay^T v for key rows 16 ms.., value columns c0..c0 + 31."""
    gid, tig = lanes()
    acc = np.zeros((4, 32, 4))
    for kk in range(8):                   # rows past the chunk are zero
        pa = row_off(8 * kk + tig, LDB) + 16 * ms + gid
        a = np.stack([KC.load(pa), KC.load(pa + 8), KC.load(pa + 4 * LDB),
                      KC.load(pa + 4 * LDB + 8)], 1)
        pv = row_off(8 * kk + tig, V.ld, V.esize) + c0 + gid
        for nt in range(4):
            mma(acc[nt], a, np.stack([V.load(pv + 8 * nt),
                                      V.load(pv + 8 * nt + 4 * V.ld)], 1))
    return acc


def scatter(frags, r0, c0, out):
    """Accumulator fragments (nt, 32, 4) of rows r0.. into out."""
    gid, tig = lanes()
    for nt, f in enumerate(frags):
        col = c0 + 8 * nt + 2 * tig
        out[r0 + gid, col], out[r0 + gid, col + 1] = f[:, 0], f[:, 1]
        out[r0 + gid + 8, col], out[r0 + gid + 8, col + 1] = f[:, 2], f[:, 3]


@pytest.mark.parametrize("n,rows", [(64, 64), (64, 37), (24, 64), (40, 9)])
def test_fragment_model_of_the_products(n, rows):
    """o = tril(rd kd^T, -1) v + rp S over the 10 lower score tiles, the
    pair's parts added, and kdecay^T v, by the fragment model, equal plain
    products on a 64 x 64 tile, with rows and channels past ``rows`` and
    ``n`` zero as the kernel's loads leave them; every load of the f32
    tiles and of a bf16 v falls on distinct banks."""
    rng = np.random.RandomState(n + rows)

    def mat(cols=n):
        x = np.zeros((TILE, TILE))
        x[:rows, :cols] = rng.randn(rows, cols)
        return x

    rd, kd, rp, v, kc = mat(), mat(), mat(), mat(), mat()
    s = np.zeros((TILE, TILE))
    s[:n, :n] = rng.randn(n, n)
    RD, KD, RP = Smem(rd, LDA), Smem(kd, LDA), Smem(rp, LDA)
    KC, V = Smem(kc, LDB), Smem(v, LDV, esize=2)
    S = Smem(np.pad(s, ((0, 0), (0, LDB - TILE))), LDB, skewed=False)
    Ob, o = {}, np.zeros((TILE, TILE))
    for m in range(4):
        if 16 * m >= rows:
            continue
        strip(RD, KD, RP, S, V, Ob, m, 1)
        scatter(strip(RD, KD, RP, S, V, Ob, m, 0), 16 * m, 0, o)
    want = np.tril(rd @ kd.T, -1) @ v + rp @ s
    np.testing.assert_allclose(o[:rows, :n], want[:rows, :n], rtol=1e-12,
                               atol=1e-10)
    upd = np.zeros((TILE, TILE))
    for w in range(8):
        ms, c0 = w >> 1, 32 * (w & 1)
        scatter(state(KC, V, ms, c0), 16 * ms, c0, upd)
    np.testing.assert_allclose(upd[:n, :n], (kc.T @ v)[:n, :n], rtol=1e-12,
                               atol=1e-10)
    for tile in (RD, KD, RP, KC, V, S):
        assert tile.loads and all(conflict_free(w) for w in tile.loads)


def test_prefix_loads_and_stores_fall_on_distinct_banks():
    """The prefix's thread (channels n, n + 1 = 8 warp + 2 (lane >> 3),
    rows 8 seg + i, seg = lane & 7) reads logw and r, k and writes the
    factors as pairs; each 8-byte access of a half warp (f32 tiles) and
    each 4-byte access of a warp (bf16 r, k) falls on distinct banks."""
    lane = np.arange(32)
    for warp in range(8):
        n = 8 * warp + 2 * (lane >> 3)
        seg = lane & 7
        for i in range(8):
            t = 8 * seg + i
            for ld in (LDA, LDB):            # f32 pairs: two words a lane
                words = np.stack([row_off(t, ld) + n,
                                  row_off(t, ld) + n + 1], 1)
                for half in (words[:16], words[16:]):
                    assert conflict_free(half.ravel())
            assert conflict_free((row_off(t, LDV, 2) + n) * 2 // 4)
