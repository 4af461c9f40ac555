"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the arithmetic that turns
operations and bytes into least times."""
from __future__ import annotations

BF16_FLOPS = 989e12          # bf16 tensor cores, dense
TF32_FLOPS = 495e12          # TF32 tensor cores, dense
F32_FLOPS = 67e12            # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, one direction, per card


def hbm_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def link_seconds(nbytes: float) -> float:
    return nbytes / NVLINK_BYTES_PER_S
