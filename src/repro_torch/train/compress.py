"""Gradient compression for the data-parallel all-reduce, with error
feedback (counterpart of ``repro/train/compress.py``).

Two compressors, both with error-feedback residuals (the compression error
is added back to the next step's gradient, so it does not accumulate):

- ``bf16``: the payload cast to bf16 (half the bytes);
- ``int8``: one f32 scale a tensor (its absmax / 127) and int8 codes, rounded
  half to even as ``jnp.round`` rounds (``torch.round`` does too) (a quarter
  of the bytes).

:func:`allreduce_mean_compressed` is the collective: where the reference
``psum``s and ``pmax``es over mesh axes inside ``shard_map``, the port
``all_reduce``s (SUM, MAX) over a ``torch.distributed`` group, e.g. the
ranks of ``launch/_ranks.py::run_ranks``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.utils import tree_get, tree_map, tree_map_with_path


def compress_int8(g: torch.Tensor, residual: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (int8 payload, f32 scale, new residual)."""
    gf = g.to(torch.float32) + (residual if residual is not None else 0.0)
    scale = torch.clamp_min(torch.amax(torch.abs(gf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_residual = gf - q.to(torch.float32) * scale
    return q, scale, new_residual


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, residuals, mode: str):
    """Compress every leaf → (payload tree, scale tree or None, new residuals)."""
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), None, residuals
    if mode == "int8":
        if residuals is None:
            residuals = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
        parts = {}  # path → (payload, scale, residual)
        tree_map_with_path(lambda path, g: parts.__setitem__(path, compress_int8(g, tree_get(residuals, path))),
                           grads)
        return tuple(tree_map_with_path(lambda path, _, i=i: parts[path][i], grads) for i in range(3))
    raise ValueError(f"unknown compression mode {mode!r}")


def allreduce_mean_compressed(grads, residuals, *, group=None, mode: str = "int8"):
    """Compress → all-reduce over ``group`` (the default group when None) →
    decompress → mean. Returns (mean gradients f32, new residuals).

    int8 payloads are summed in int32 (exact for up to 2^23 ranks) and
    rescaled by the largest rank's scale: the reference's shared-scale
    reduction (its payloads are not re-quantized to that scale)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def all_sum(t, op=dist.ReduceOp.SUM):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    if mode == "none":
        return tree_map(lambda g: all_sum(g) / n, grads), residuals
    payload, scales, new_res = compress_tree(grads, residuals, mode)
    if mode == "bf16":
        return tree_map(lambda p: all_sum(p.to(torch.float32)) / n, payload), new_res
    summed = tree_map(lambda p: all_sum(p.to(torch.int32)), payload)
    max_scale = tree_map(lambda s: all_sum(s, dist.ReduceOp.MAX), scales)
    return tree_map_with_path(lambda path, s: s.to(torch.float32) * tree_get(max_scale, path) / n, summed), new_res
