"""Data pipeline (numpy-only): index-addressable synthetic and memmapped
token batches."""
from .pipeline import MemmapDataset, SyntheticLM

__all__ = ["SyntheticLM", "MemmapDataset"]
