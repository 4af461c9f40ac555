"""Three-term roofline from the dry run's per-device counts (the
reference's ``repro/analysis/roofline.py``, for the H100):

    compute term    = dot_FLOPs    / (chips * peak_FLOP/s)
    memory term     = bytes        / (chips * HBM_bw)
    collective term = collective_B / (chips * links * link_bw)

The counts come from :func:`repro_torch.analysis.hlo.analyze_program`,
one device's share of the program, so chips=1 in the denominators and the
terms are per-device step times; MODEL_FLOPS is divided by the device
count for the utilization ratio.

The constants are the NVIDIA H100 80GB HBM3's (SXM, run at a 700.00 W
power limit), the same peaks as the bounds of the port's kernel table:
989e12 FLOP/s dense bf16 on the tensor cores and 3.35e12 B/s of HBM3,
both from the card's datasheet, not measured.  The link rate is read,
not copied, from ``CostModel.for_backend("cuda")`` (the port's fitted row
of :mod:`repro_torch.core.collectives`, fitted on that card at 700.00 W:
the rate of one stacked-fabric wave per wire byte), so it moves when that
row is refitted.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.collectives import CostModel

PEAK_FLOPS = 989e12        # bf16 dense per card (H100 SXM datasheet)
HBM_BW = 3.35e12           # bytes/s per card (H100 SXM datasheet)


def link_bw() -> float:
    """bytes/s of one wave's wire: the fitted cuda row's ``link_bw``."""
    return CostModel.for_backend("cuda").link_bw


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float           # 6*N*D (train) or 2*N*D (serve), per device
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs -- catches remat/redundancy waste."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(model_flops / peak) / bound -- fraction of the card's peak the
        step achieves if it runs exactly at the roofline bound."""
        ideal = self.model_flops / PEAK_FLOPS
        return ideal / self.bound_s if self.bound_s else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def _attention_flops_per_token(cfg, seq_len: int) -> float:
    """Useful attention matmul FLOPs per token: 4 * L_attn * ctx * H * hd
    (qk^T + pv), with causal avg ctx = S/2, clipped by sliding window.
    Attention-free (rwkv6) and recurrent layers contribute ~0 here (their
    state math is counted in active params)."""
    if cfg.family == "rwkv6":
        return 0.0
    n_attn_layers = cfg.n_layers + cfg.n_dec_layers
    if cfg.family == "rglru":
        pat = cfg.pattern or ("rec", "rec", "attn")
        n_attn_layers = sum(
            1 for i in range(cfg.n_layers) if pat[i % len(pat)] == "attn")
    ctx = seq_len / 2.0
    if cfg.window:
        ctx = min(ctx, float(cfg.window))
    return 4.0 * n_attn_layers * ctx * cfg.n_heads * cfg.head_dim_


def model_flops_for(cfg, shape, n_devices: int) -> float:
    """Per-device MODEL_FLOPS: (6 |train, 2 |serve) * N_active * D plus the
    attention-matmul term (3x for train fwd+bwd), which dominates small
    models at 32k context."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        attn = 3.0 * _attention_flops_per_token(cfg, shape.seq_len)
        return (6.0 * n_active + attn) * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        attn = _attention_flops_per_token(cfg, shape.seq_len)
        return (2.0 * n_active + attn) * tokens / n_devices
    tokens = shape.global_batch  # one token per sequence
    attn = 2.0 * _attention_flops_per_token(cfg, shape.seq_len)  # full ctx
    return (2.0 * n_active + attn) * tokens / n_devices


def roofline(cfg, shape, mesh_name: str, n_devices: int,
             hlo_flops: float, hlo_bytes: float,
             collective_bytes: float, links_per_chip: float = 1.0
             ) -> RooflineTerms:
    """All count inputs are per-device.  ``links_per_chip`` defaults to 1:
    the fitted cuda row times the stacked fabric's waves one after
    another on one card, so its ``link_bw`` is the rate of one wire at a
    time; no wave between two cards has been timed yet."""
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_name,
        compute_s=hlo_flops / PEAK_FLOPS,
        memory_s=hlo_bytes / HBM_BW,
        collective_s=collective_bytes / (links_per_chip * link_bw()),
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops_for(cfg, shape, n_devices),
        n_devices=n_devices,
    )
