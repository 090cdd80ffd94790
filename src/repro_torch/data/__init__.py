"""Synthetic data: the Markov corpus and its host-sharded training loader."""

from repro_torch.data.synthetic import MarkovCorpus, batch_iterator

__all__ = ["MarkovCorpus", "batch_iterator"]
