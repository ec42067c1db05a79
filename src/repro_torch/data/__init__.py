"""The port's synthetic data pipeline (the reference's numpy draws)."""
from .pipeline import SyntheticLM, make_batch

__all__ = ["SyntheticLM", "make_batch"]
