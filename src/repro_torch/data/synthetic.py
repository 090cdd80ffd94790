"""Deterministic synthetic language data (the port's copy of the
reference's ``repro/data/synthetic.py``: ``MarkovCorpus``, which the serving
CLI draws its prompts from, and the training loader ``batch_iterator`` with
its embeddings table; numpy only, so the same seeds give the same arrays in
both packages, bit for bit).

A fixed sparse first-order Markov chain over the vocabulary: each token moves
to one of ``branching`` successors with Zipf weights, learnable structure, so
a training loss falls and a quantized model's NLL can be held against the
dense one's (the paper's Figs. 5/6). The loader is host-sharded: a process
takes its ``process_index``-th slice of the global batch.
"""

from __future__ import annotations

from typing import Iterator, Optional

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


def batch_iterator(
    corpus: MarkovCorpus,
    *,
    batch: int,
    seq_len: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    embed_dim: Optional[int] = None,
) -> Iterator[dict]:
    """Yields numpy ``{"tokens", "labels"}`` (labels: the tokens shifted by
    one), or ``{"embeddings", "labels"}`` for an embeddings-input model
    (``embed_dim``: each token's row of :func:`_embed_table`)."""
    assert batch % process_count == 0
    local = batch // process_count
    step = 0
    while True:
        toks = corpus.sample(batch, seq_len, seed=seed * 1_000_003 + step)
        toks = toks[process_index * local : (process_index + 1) * local]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
        if embed_dim is not None:
            table = _embed_table(corpus.vocab, embed_dim)
            out = {"embeddings": table[out["tokens"]], "labels": out["labels"]}
        yield out
        step += 1


_TABLES: dict = {}


def _embed_table(vocab: int, dim: int) -> np.ndarray:
    """A fixed ``(vocab, dim)`` f32 table of N(0, 0.4²) rows from seed 1234,
    kept per shape."""
    key = (vocab, dim)
    if key not in _TABLES:
        rng = np.random.default_rng(1234)
        _TABLES[key] = rng.standard_normal((vocab, dim)).astype(np.float32) * 0.4
    return _TABLES[key]
