from .adamw import AdamW, OptState, cosine_schedule, global_norm_clip

__all__ = ["AdamW", "OptState", "cosine_schedule", "global_norm_clip"]
