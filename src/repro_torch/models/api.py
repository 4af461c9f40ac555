"""Unified model API (the reference's ``repro/models/api.py``): one entry
point per architecture family.

``build(cfg)`` returns a :class:`ModelAPI` exposing init / loss / prefill /
decode plus ``input_specs(shape)`` (stand-ins of every model input, on the
``meta`` device) and the logical batch axes of each input.

Departures from the reference, until the port has ``dist/sharding.py``:
``init`` returns the parameter tree and ``init_cache`` the caches without
their logical axes, and ``input_specs`` gives ``meta`` tensors where the
reference gives ``jax.ShapeDtypeStruct``\\ s.  Every prefill runs the
family's kernels; the losses run the plain versions (autograd).
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
