"""Architecture + shape configuration (own copy of the reference's
``repro.configs.base``; the activation dtype maps through a torch table)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# the LM-family shape set: every arch pairs with these four
LM_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # lm | moe | encdec | vlm | rglru | rwkv6
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None        # sliding-window attention
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared: int = 0
    moe_renorm: bool = True
    moe_group_size: int = 512
    moe_capacity_factor: float = 1.0
    moe_seq_shard_out: bool = False
    # encdec
    n_dec_layers: int = 0
    # vlm
    n_img_tokens: int = 1_024
    # rglru (recurrentgemma)
    lru_width: int = 0               # 0 -> d_model
    pattern: tuple = ()              # e.g. ("rec", "rec", "attn")
    conv_width: int = 4
    # rwkv6
    head_size: int = 64
    # runtime
    act_dtype_name: str = "bfloat16"
    remat: bool = True
    q_block: int = 1_024
    kv_block: int = 1_024
    # serve-time (prefill/decode) attention blocks of the reference's
    # blockwise attention (the port's prefill runs the flash kernel)
    serve_q_block: int = 4_096
    serve_kv_block: int = 4_096
    aux_loss_weight: float = 0.01
    tp_divisor: int = 16             # model-axis size params get padded for
    skip_shapes: tuple = ()
    skip_reason: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = 16 * self.tp_divisor
        return -(-self.vocab // m) * m

    @property
    def n_experts_padded(self) -> int:
        if not self.n_experts:
            return 0
        return -(-self.n_experts // self.tp_divisor) * self.tp_divisor

    @property
    def act_dtype(self) -> torch.dtype:
        return DTYPES[self.act_dtype_name]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def shapes(self) -> tuple:
        return tuple(s for s in LM_SHAPES if s.name not in self.skip_shapes)

    def shape(self, name: str) -> ShapeSpec:
        for s in LM_SHAPES:
            if s.name == name:
                return s
        raise KeyError(name)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6 N D)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * hd * (self.n_heads * 2 + self.n_kv * 2)
        if self.family == "rwkv6":
            attn = 5 * d * d + d * 32 * 6  # r,k,v,g,o + lora decays (approx)
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_expert + \
                self.n_shared * 3 * d * self.d_expert + d * self.n_experts
        else:
            mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            ffn = mult * d * self.d_ff
        layers = self.n_layers + self.n_dec_layers
        return layers * (attn + ffn) + self.vocab * d

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        attn = d * self.head_dim_ * (self.n_heads * 2 + self.n_kv * 2)
        ffn = (self.top_k + self.n_shared) * 3 * d * self.d_expert \
            + d * self.n_experts
        return self.n_layers * (attn + ffn) + self.vocab * d

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv, heads))
        while heads % kv:
            kv -= 1
        kw = dict(
            n_layers=len(self.pattern) or 2,
            d_model=128, n_heads=heads, n_kv=kv, head_dim=32,
            d_ff=192, vocab=256, tp_divisor=1,
            q_block=64, kv_block=64, remat=False,
            act_dtype_name="float32",
        )
        if self.is_moe:
            kw.update(n_experts=8, top_k=min(self.top_k, 2),
                      d_expert=64, n_shared=min(self.n_shared, 1),
                      moe_group_size=32)
        if self.family == "encdec":
            kw.update(n_layers=2, n_dec_layers=2)
        if self.family == "vlm":
            kw.update(n_img_tokens=8)
        if self.family == "rglru":
            kw.update(lru_width=128, window=32, head_dim=32)
        if self.family == "rwkv6":
            kw.update(head_size=32)
        if self.window is not None and self.family != "rglru":
            kw.update(window=32)
        return dataclasses.replace(self, **kw)
