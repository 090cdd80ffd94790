"""Small shared helpers: device resolution, dense products and row sums whose
batch rows do not depend on the batch, and walks over parameter trees.

A parameter tree is nested ``dict``s and ``tuple``s (the JAX package's pytree
layout) whose leaves are tensors or :class:`~repro_torch.core.qtensor.
QuantizedTensor` containers, which count as one leaf each.
"""

from __future__ import annotations

import contextlib
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
# The same for a prompt's rows: a prompt prefilled whole, in chunks, or as
# the suffix after a cached prefix must give each row the same bits, so its
# rows also run in fixed tiles, wider ones because a prompt's product is
# bound by operations (the width was picked on the card, ``chip_smoke.py``
# phase 3, between 64 and 128).
PROMPT_TILE = 128


_PROMPT_ROWS = False  # set by prompt_rows()


@contextlib.contextmanager
def prompt_rows(on: bool = True):
    """Within this scope every product's rows are a prompt's, whatever their
    shape: a one-token prompt chunk (``(1, 1, k)``) then takes the prompt
    tiles, as its row does in the whole prompt, not a decode step's tiles,
    and the prefill attention (``models/model.py::forward(prefill=True)``,
    ``models/layers.py::attention``). Not thread-safe (one
    module-level setting, like ``kernels.ops.impl_mode``)."""
    global _PROMPT_ROWS
    prev, _PROMPT_ROWS = _PROMPT_ROWS, bool(on)
    try:
        yield
    finally:
        _PROMPT_ROWS = prev


def in_prompt_rows() -> bool:
    """Whether a :func:`prompt_rows` scope is in force."""
    return _PROMPT_ROWS


_ROW_TILES = False  # set by row_tiles()


@contextlib.contextmanager
def row_tiles():
    """Within this scope :func:`matmul_rows` cuts every product into the
    GPU's fixed row tiles whatever device its tensors lie on: the dry run
    (``launch/dryrun.py``) traces the card's route on meta tensors, since
    a CPU-only build cannot make CUDA tensors, not even fake ones.
    Not thread-safe (one module-level setting, like :func:`prompt_rows`)."""
    global _ROW_TILES
    prev, _ROW_TILES = _ROW_TILES, True
    try:
        yield
    finally:
        _ROW_TILES = prev


def stream_capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph: never before
    CUDA is initialized (nor in a CPU-only build, whose ``torch.cuda``
    cannot be asked), which costs a flag's read."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def host_pos(pos) -> int:
    """A scalar position (an int or a 0-d tensor) as a Python int. A CUDA
    graph would keep the value read at capture, and every replay would write
    and mask at that position without an error, so this raises while a
    stream captures: a captured step takes its positions as a ``(B,)``
    device tensor (``infer/graphs.py``)."""
    if stream_capturing():
        raise RuntimeError(
            "a scalar position reached a step under CUDA graph capture; a captured "
            "step takes its positions as a (B,) tensor"
        )
    return int(pos)


def token_rows(x: torch.Tensor) -> bool:
    """Whether each row of ``x (..., k)`` is one token of its own request:
    ``x`` is ``(B, k)``, or ``(B, 1, ..., 1, k)`` (a decode step over B
    requests), as opposed to a prompt's ``(B, S, k)`` with S > 1, or any
    rows inside :func:`prompt_rows`."""
    return not _PROMPT_ROWS and math.prod(x.shape[1:-1]) == 1


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
    - On the GPU (and on any device inside :func:`row_tiles`) a call
      whose rows are one token each (:func:`token_rows`) runs in tiles of
      ``ROW_TILE`` rows (:func:`matmul_row_tiles`), any other call, a
      prompt's, in tiles of ``PROMPT_TILE`` rows: a prompt row then gets
      the same bits whether the prompt is prefilled whole or in chunks, or
      after a cached prefix."""
    if x.dim() < 2 or x.shape[0] == 0:
        return torch.matmul(x, w)
    if not (x.is_cuda or _ROW_TILES):
        if x.shape[0] == 1:
            return torch.matmul(x, w)
        return torch.cat([torch.matmul(r[None], w) for r in x])
    rows = ROW_TILE if token_rows(x) else PROMPT_TILE
    y = matmul_row_tiles(x.reshape(-1, x.shape[-1]), w, rows)
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


def tree_get(tree, path: Tuple):
    """The subtree of ``tree`` at ``path`` (:func:`tree_map_with_path`'s)."""
    for key in path:
        tree = tree[key]
    return tree


def tree_map(fn: Callable[[Any], Any], tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out
