"""Small shared helpers: device resolution and walks over parameter trees.

A parameter tree is nested ``dict``s and ``tuple``s (the JAX package's pytree
layout) whose leaves are tensors or :class:`~repro_torch.core.qtensor.
QuantizedTensor` containers, which count as one leaf each.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a usable
    GPU raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (B, ..., k) @ w (k, o)`` where a batch row's result does not
    depend on how many rows share the call. On the CPU each leading batch
    row is its own product: the CPU BLAS takes another kernel, and sums k in
    another order, for a batch of B decode rows than for one, and a slot
    batch must decode each request exactly as a batch of one does
    (``infer/scheduler.py``). On the GPU, one product."""
    if x.is_cuda or x.dim() < 2 or x.shape[0] <= 1:
        return torch.matmul(x, w)
    return torch.cat([torch.matmul(r[None], w) for r in x])


def tree_map_with_path(
    fn: Callable[[Tuple, Any], Any], tree, path: Tuple = ()
):
    """Apply ``fn(path, leaf)`` to every leaf; ``path`` holds dict keys and
    sequence indices from the root. Containers keep their type."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)
        )
    return fn(path, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out
