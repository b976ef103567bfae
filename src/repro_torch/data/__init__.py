"""Data pipeline: deterministic synthetic LM stream + device prefetch."""
from .pipeline import PrefetchIterator, SyntheticLM

__all__ = ["PrefetchIterator", "SyntheticLM"]
