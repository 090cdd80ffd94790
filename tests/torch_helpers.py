"""Helpers shared by the ``tests/test_torch_*.py`` parity tests: carry JAX
pytrees across to numpy trees the port's ``params_from_numpy`` accepts."""

from __future__ import annotations

import numpy as np
import torch

from repro.core.qtensor import QuantizedTensor as JaxQT

# The port's CPU tests run small tensors; torch's intra-op thread pool only
# contends with the other test workers sharing the host's cores.
torch.set_num_threads(1)


def jax_tree_to_numpy(tree):
    """JAX params pytree → nested dicts/tuples of numpy arrays; quantized
    leaves become ``{"packed", "scales", "g", "k", "o", "fmt"}`` dicts."""
    if isinstance(tree, JaxQT):
        return {
            "packed": np.asarray(tree.packed),
            "scales": np.asarray(tree.scales),
            "g": tree.g,
            "k": tree.k,
            "o": tree.o,
            "fmt": tree.fmt,
        }
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(jax_tree_to_numpy(v) for v in tree)
    return np.asarray(tree)


def quantized_paths(tree, path=()):
    """{path: (q, g, k, o)} of every quantized leaf, for either package
    (both containers expose ``q``, ``g``, ``k`` and ``o``)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(quantized_paths(v, path + (k,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(quantized_paths(v, path + (i,)))
    elif hasattr(tree, "packed") and hasattr(tree, "g"):
        out[path] = (tree.q, tree.g, tree.k, tree.o)
    return out
