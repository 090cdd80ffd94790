"""Synthetic data."""

from repro_torch.data.synthetic import MarkovCorpus

__all__ = ["MarkovCorpus"]
