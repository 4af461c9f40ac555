from .adamw import AdamW, OptState, cosine_schedule, global_norm_clip
from .sharded import (ShardedAdamW, ShardedOptState, decay_mask,
                      zero1_geometry)

__all__ = ["AdamW", "OptState", "cosine_schedule", "global_norm_clip",
           "ShardedAdamW", "ShardedOptState", "decay_mask",
           "zero1_geometry"]
