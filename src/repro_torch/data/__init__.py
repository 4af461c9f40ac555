from .pipeline import SyntheticLMStream, make_batch_for

__all__ = ["SyntheticLMStream", "make_batch_for"]
