"""Small shared helpers: device resolution, dense products and row sums whose
batch rows do not depend on the batch, and walks over parameter trees.

A parameter tree is nested ``dict``s and ``tuple``s (the JAX package's pytree
layout) whose leaves are tensors or :class:`~repro_torch.core.qtensor.
QuantizedTensor` containers, which count as one leaf each.
"""

from __future__ import annotations

import math
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


# Rows of one fixed-shape product on the GPU: every decode call is cut into
# zero-padded tiles of this many rows, so each tile is the same (R, k) @
# (k, o) library call (the same cuBLAS algorithm, the same sum order), and
# a row's bits depend on its own values alone. A memory-bound product costs
# about the same at 8 rows as at 1.
ROW_TILE = 8


def token_rows(x: torch.Tensor) -> bool:
    """Whether each row of ``x (..., k)`` is one token of its own request:
    ``x`` is ``(B, k)``, or ``(B, 1, ..., 1, k)`` (a decode step over B
    requests), as opposed to a prompt's ``(B, S, k)`` with S > 1."""
    return math.prod(x.shape[1:-1]) == 1


def matmul_row_tiles(x: torch.Tensor, w: torch.Tensor, rows: int = ROW_TILE) -> torch.Tensor:
    """``x (B, k) @ w (k, o)`` as one ``(rows, k) @ (k, o)`` product per tile
    of ``rows`` rows, the last tile zero-padded: ``(B, o)``. Every tile is
    copied into one fresh buffer first, so each product sees the same shape
    and the same alignment whatever B is and wherever ``x`` lay."""
    B, k = x.shape
    xp = x.new_zeros((-(-B // rows) * rows, k))
    xp[:B] = x
    if xp.shape[0] == rows:  # one tile: nothing to join
        return torch.matmul(xp, w)[:B]
    return torch.cat([torch.matmul(xp[t : t + rows], w) for t in range(0, xp.shape[0], rows)])[:B]


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (B, ..., k) @ w (k, o)`` where a batch row's result does not
    depend on how many rows share the call. A slot batch must decode each
    request exactly as a batch of one does (``infer/scheduler.py``), and a
    library product may take another kernel, and sum k in another order,
    for B rows than for one.

    - On the CPU each leading batch row is its own product.
    - On the GPU a call whose rows are one token each (:func:`token_rows`)
      runs in tiles of ``ROW_TILE`` rows (:func:`matmul_row_tiles`); any
      other call, a prompt's, is one product: an admission prefills one
      request alone, as its solo ``generate`` does."""
    if x.dim() < 2 or x.shape[0] == 0:
        return torch.matmul(x, w)
    if not x.is_cuda:
        if x.shape[0] == 1:
            return torch.matmul(x, w)
        return torch.cat([torch.matmul(r[None], w) for r in x])
    if not token_rows(x):
        return torch.matmul(x, w)
    y = matmul_row_tiles(x.reshape(x.shape[0], x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


# Widest reduction of :func:`row_sum`'s stages: a sum over a last axis this
# short gets one warp per output from torch's CUDA reduction at any number of
# outputs, so its order of summation is fixed.
ROW_SUM_WIDTH = 32


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1, keepdim=True)`` whose result for one row does not depend
    on how many rows share the call. torch's CUDA reduction picks its block
    shape, and so its order of summation, from the number of outputs as well
    as from the reduced length (for 3072 values: 512 lanes a row for one
    row, 128 for four, 32 from sixteen on), so ``torch.mean`` of a decode
    step's rows and of a speculative verify's rows would round differently.
    Here the last axis is summed in stages of :data:`ROW_SUM_WIDTH` values
    (zero-padded), each of which torch reduces in one warp per output
    whatever the row count."""
    while x.shape[-1] > ROW_SUM_WIDTH:
        pad = -x.shape[-1] % ROW_SUM_WIDTH
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        x = x.reshape(*x.shape[:-1], -1, ROW_SUM_WIDTH).sum(-1)
    return x.sum(-1, keepdim=True)


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
