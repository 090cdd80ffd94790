"""The rank body of ``tests/test_torch_compress.py``'s all-reduce test, run
in each spawned rank of a gloo group. This module imports nothing of JAX,
so the ranks never load it."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.train.compress import allreduce_mean_compressed


def grads_of(rank: int) -> dict:
    """A rank's gradient tree: different values a rank, one tree shape."""
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * (1 + rank),
            "b": (rng.standard_normal(7).astype(np.float32) * 0.01,)}


def allreduce_rank(rank: int, n: int, mode: str) -> dict:
    """One all-reduce of this rank's gradients, with and without a residual
    → numpy results."""
    g = {"w": torch.from_numpy(grads_of(rank)["w"]), "b": (torch.from_numpy(grads_of(rank)["b"][0]),)}
    out, res = allreduce_mean_compressed(g, None, mode=mode)
    res_in = None if res is None else res
    out2, res2 = allreduce_mean_compressed(g, res_in, mode=mode)

    def flat(t):
        return None if t is None else {"w": t["w"].numpy(), "b": t["b"][0].numpy()}

    return {"out": flat(out), "res": flat(res), "out2": flat(out2), "res2": flat(res2)}
