"""Deterministic synthetic token streams (the port's copy of the reference's
``repro/data/synthetic.py::MarkovCorpus``, which the serving CLI draws its
prompts from; same seeds give the same tokens in both packages).

A fixed sparse first-order Markov chain over the vocabulary: each token moves
to one of ``branching`` successors with Zipf weights.
"""

from __future__ import annotations

import numpy as np


class MarkovCorpus:
    def __init__(self, vocab: int, branching: int = 8, seed: int = 0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.successors = rng.integers(0, vocab, size=(vocab, branching))
        w = 1.0 / np.arange(1, branching + 1)
        self.weights = w / w.sum()
        self.branching = branching

    def sample(self, batch: int, seq_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            choice = rng.choice(self.branching, size=batch, p=self.weights)
            toks[:, t + 1] = self.successors[toks[:, t], choice]
        return toks
