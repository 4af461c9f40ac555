"""Unified model API (the reference's ``repro/models/api.py``): one entry
point per architecture family.

``build(cfg)`` returns a :class:`ModelAPI` exposing init / loss / prefill /
decode plus ``input_specs(shape)`` (stand-ins of every model input, on the
``meta`` device) and the logical axes of every parameter
(``param_axes()``), cache (``cache_axes(batch, max_len)``) and batch input
(``batch_axes(shape)``), which :mod:`repro_torch.dist.sharding` turns into
placements.

The reference's ``init`` and ``init_cache`` return ``(tree, axes)``; here
``init`` and ``init_cache`` return the tree and the axes come from
``param_axes()`` / ``cache_axes()``, which allocate nothing.
``input_specs`` gives ``meta`` tensors where the reference gives
``jax.ShapeDtypeStruct``\\ s.  Every prefill runs the family's kernels;
the losses run the plain versions (autograd).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig, ShapeSpec
from . import encdec, rglru, rwkv6, transformer, vlm

ENC_LEN_FOR_DECODE = 4_096   # encoder length used by enc-dec decode cells


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable          # (gen, device) -> params
    loss_fn: Callable       # (params, batch) -> (loss, metrics)
    prefill_fn: Callable    # (params, batch) -> (last logits, caches)
    decode_fn: Callable     # (params, caches, batch) -> (logits, new_caches)
    init_cache: Callable    # (batch_size, max_len, device) -> caches

    # ---- logical axes ------------------------------------------------------
    def param_axes(self) -> dict:
        """The tree of logical axis tuples parallel to ``init``'s
        parameters (the reference's ``init(key)[1]``)."""
        return _PARAM_AXES[self.cfg.family](self.cfg)

    def cache_axes(self, batch: int = 1, max_len: int = 1):
        """The axes tree parallel to ``init_cache(batch, max_len)``'s
        caches (the reference's ``init_cache(batch, max_len)[1]``; the
        axes do not depend on the sizes)."""
        f = self.cfg.family
        if f == "rglru":
            return {"kv_k": _KV_CACHE, "kv_v": _KV_CACHE,
                    "state": ("layers", "batch", "mlp"),
                    "conv": ("layers", "batch", None, "mlp"),
                    "kv_pos": (None,)}
        if f == "rwkv6":
            return {"state": ("layers", "batch", "heads", None, None),
                    "last_tm": ("layers", "batch", "embed"),
                    "last_cm": ("layers", "batch", "embed")}
        return (_KV_CACHE, _KV_CACHE)

    # ---- stand-ins ---------------------------------------------------------
    def input_specs(self, shape: ShapeSpec) -> dict:
        """``meta`` tensors of every model input of this (arch, shape):
        the reference's shapes and dtypes, no allocation."""
        cfg, gb, s = self.cfg, shape.global_batch, shape.seq_len
        i32, act = torch.int32, cfg.act_dtype
        f = cfg.family
        if shape.kind == "train":
            if f == "encdec":
                return {"frames": _spec((gb, s, cfg.d_model), act),
                        "tokens": _spec((gb, s + 1), i32)}
            if f == "vlm":
                n_txt = s - cfg.n_img_tokens
                return {"patches": _spec((gb, cfg.n_img_tokens, cfg.d_model),
                                         act),
                        "tokens": _spec((gb, n_txt + 1), i32)}
            return {"tokens": _spec((gb, s + 1), i32)}
        if shape.kind == "prefill":
            if f == "encdec":
                return {"frames": _spec((gb, s, cfg.d_model), act),
                        "tokens": _spec((gb, s), i32)}
            if f == "vlm":
                return {"patches": _spec((gb, cfg.n_img_tokens, cfg.d_model),
                                         act),
                        "tokens": _spec((gb, s - cfg.n_img_tokens), i32)}
            return {"tokens": _spec((gb, s), i32)}
        # decode: one new token against a cache of length s
        batch = {"tokens": _spec((gb, 1), i32), "cache_len": _spec((), i32)}
        if f == "encdec":
            batch["cross_k"] = _spec(
                (cfg.n_dec_layers, gb, ENC_LEN_FOR_DECODE, cfg.n_kv,
                 cfg.head_dim_), torch.bfloat16)
            batch["cross_v"] = batch["cross_k"]
        return batch

    def batch_axes(self, shape: ShapeSpec) -> dict:
        """Logical axis names per batch input (for sharding rules)."""
        out = {}
        for k, v in self.input_specs(shape).items():
            if k == "cache_len":
                out[k] = ()
            elif k in ("cross_k", "cross_v"):
                out[k] = ("layers", "batch", None, "kv_heads", "head_dim")
            else:
                out[k] = ("batch",) + (None,) * (v.dim() - 1)
        return out


# ---------------------------------------------------------------------------
# logical axes of the parameters, as the reference's inits give them
# ---------------------------------------------------------------------------

_KV_CACHE = ("layers", "batch", None, "kv_heads", "head_dim")
_RMS = {"scale": ("embed",)}
_LN = {"scale": ("embed",), "bias": ("embed",)}
_EMBED = {"table": ("vocab", "embed")}
_GLU = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
        "wo": ("mlp", "embed")}
_DENSE = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def _stacked(tree):
    """``tree`` with the stacked ``layers`` dim in front of every leaf."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return ("layers",) + tree


def _attention_axes(qkv_bias=False, qk_norm=False) -> dict:
    a = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if qkv_bias:
        a.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if qk_norm:
        a.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return a


def _lm_axes(cfg) -> dict:
    layer = {"ln1": _RMS, "attn": _attention_axes(cfg.qkv_bias, cfg.qk_norm),
             "ln2": _RMS}
    if cfg.is_moe:
        moe = {"router": ("embed", "experts"),
               "wi_gate": ("experts", "embed", "mlp"),
               "wi_up": ("experts", "embed", "mlp"),
               "wo": ("experts", "mlp", "embed")}
        if cfg.n_shared:
            moe["shared"] = {**_GLU, "gate": ("embed", None)}
        layer["moe"] = moe
    else:
        layer["mlp"] = _GLU
    return {"embed": _EMBED, "layers": _stacked(layer), "final_norm": _RMS}


def _vlm_axes(cfg) -> dict:
    return {**_lm_axes(cfg), "patch_proj": {"w": ("embed", "embed2")}}


def _encdec_axes(cfg) -> dict:
    attn = _attention_axes()
    enc = {"ln1": _LN, "attn": attn, "ln2": _LN, "mlp": _DENSE}
    dec = {"ln1": _LN, "attn": attn, "lnc": _LN, "cross": attn, "ln2": _LN,
           "mlp": _DENSE}
    return {"frame_proj": {"w": ("embed", "embed2")}, "embed": _EMBED,
            "enc": _stacked(enc), "dec": _stacked(dec), "enc_norm": _LN,
            "dec_norm": _LN}


def _rglru_axes(cfg) -> dict:
    rec = {"ln": _RMS, "w_gate": ("embed", "mlp"), "w_rec": ("embed", "mlp"),
           "conv_w": (None, "mlp"), "conv_b": ("mlp",),
           "wa": ("mlp", "mlp2"), "ba": ("mlp",), "wi": ("mlp", "mlp2"),
           "bi": ("mlp",), "lam": ("mlp",), "wo": ("mlp", "embed")}
    return {"embed": _EMBED, "rec": _stacked(rec),
            "att": _stacked({"ln": _RMS, "attn": _attention_axes()}),
            "mlp": _stacked({"ln": _RMS, "mlp": _GLU}), "final_norm": _RMS}


def _rwkv6_axes(cfg) -> dict:
    layer = {"ln1": _LN, "ln2": _LN, "mu_x": ("embed",), "mu": (None, "embed"),
             "tm_w1": ("embed", None), "tm_w2": (None, None, "embed"),
             "wr": ("embed", "embed2"), "wk": ("embed", "embed2"),
             "wv": ("embed", "embed2"), "wg": ("embed", "embed2"),
             "wo": ("embed2", "embed"), "w0": ("embed",),
             "dw1": ("embed", None), "dw2": (None, "embed"),
             "u": ("heads", "head_dim"), "ln_x": ("embed",),
             "cm_mu_k": ("embed",), "cm_mu_r": ("embed",),
             "cm_wk": ("embed", "mlp"), "cm_wv": ("mlp", "embed"),
             "cm_wr": ("embed", "embed2")}
    return {"embed": _EMBED, "layers": _stacked(layer), "final_norm": _LN}


_PARAM_AXES = {"lm": _lm_axes, "moe": _lm_axes, "vlm": _vlm_axes,
               "encdec": _encdec_axes, "rglru": _rglru_axes,
               "rwkv6": _rwkv6_axes}


def build(cfg: ArchConfig) -> ModelAPI:
    """The :class:`ModelAPI` of ``cfg``'s family.  A batch's
    ``cache_len`` is a Python int or a 0-d tensor."""
    f = cfg.family
    if f in ("lm", "moe"):
        return ModelAPI(
            cfg,
            init=lambda gen, device="cpu": transformer.init_lm(cfg, gen,
                                                               device),
            loss_fn=lambda p, b: transformer.loss_fn(cfg, p, b),
            prefill_fn=lambda p, b: transformer.prefill(
                cfg, p, b["tokens"], b["tokens"].shape[1]),
            decode_fn=lambda p, c, b: transformer.decode_step(
                cfg, p, c, b["tokens"], int(b["cache_len"])),
            init_cache=lambda bs, ml, device="cpu": transformer.init_cache(
                cfg, bs, ml, device=device),
        )
    if f == "encdec":
        def prefill_fn(p, b):
            enc_out = encdec.encode(cfg, p, b["frames"], fresh=True)
            logits, cache = encdec.decode(cfg, p, b["tokens"], enc_out,
                                          last_only=True, fresh=True)
            return logits[:, -1], cache
        return ModelAPI(
            cfg,
            init=lambda gen, device="cpu": encdec.init_encdec(cfg, gen,
                                                              device),
            loss_fn=lambda p, b: encdec.loss_fn(cfg, p, b),
            prefill_fn=prefill_fn,
            decode_fn=lambda p, c, b: encdec.decode_step(
                cfg, p, c, b["tokens"], int(b["cache_len"]),
                (b["cross_k"], b["cross_v"])),
            init_cache=lambda bs, ml, device="cpu": encdec.init_cache(
                cfg, bs, ml, device=device),
        )
    if f == "vlm":
        def prefill_fn(p, b):
            logits, _ = vlm.forward(cfg, p, b["tokens"], b["patches"],
                                    last_only=True, fresh=True)
            return logits[:, -1], None
        return ModelAPI(
            cfg,
            init=lambda gen, device="cpu": vlm.init_vlm(cfg, gen, device),
            loss_fn=lambda p, b: vlm.loss_fn(cfg, p, b),
            prefill_fn=prefill_fn,
            decode_fn=lambda p, c, b: vlm.decode_step(
                cfg, p, c, b["tokens"], int(b["cache_len"])),
            init_cache=lambda bs, ml, device="cpu": vlm.init_cache(
                cfg, bs, ml, device=device),
        )
    if f == "rglru":
        return ModelAPI(
            cfg,
            init=lambda gen, device="cpu": rglru.init_rglru_model(cfg, gen,
                                                                  device),
            loss_fn=lambda p, b: rglru.loss_fn(cfg, p, b),
            prefill_fn=lambda p, b: rglru.prefill(cfg, p, b["tokens"]),
            decode_fn=lambda p, c, b: rglru.decode_step(
                cfg, p, c, b["tokens"], int(b["cache_len"])),
            init_cache=lambda bs, ml, device="cpu": rglru.init_cache(
                cfg, bs, ml, device=device),
        )
    if f == "rwkv6":
        return ModelAPI(
            cfg,
            init=lambda gen, device="cpu": rwkv6.init_rwkv6_model(cfg, gen,
                                                                  device),
            loss_fn=lambda p, b: rwkv6.loss_fn(cfg, p, b),
            prefill_fn=lambda p, b: rwkv6.prefill(cfg, p, b["tokens"]),
            decode_fn=lambda p, c, b: rwkv6.decode_step(cfg, p, c,
                                                        b["tokens"]),
            init_cache=lambda bs, ml, device="cpu": rwkv6.init_cache(
                cfg, bs, ml, device=device),
        )
    raise ValueError(f"unknown family {f}")
