from .synthetic import SyntheticLMStream, batch_at

__all__ = ["SyntheticLMStream", "batch_at"]
