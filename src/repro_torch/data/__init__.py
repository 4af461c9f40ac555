from .pipeline import SyntheticLMStream

__all__ = ["SyntheticLMStream"]
