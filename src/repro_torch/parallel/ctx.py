"""The tensor-parallel region and its collectives (counterpart of
``repro/parallel/ctx.py``).

Inside a TP region (:func:`tp_shard_region`, entered by
``parallel/tp.py::TPContext.forward`` around every forward of a TP engine)
each rank holds its local weight and KV shards, so the model code itself
sums the row-parallel partial sums (:func:`psum_partial`, after every
``wo`` and ``w_down``) and gathers the vocab-split logits
(:func:`all_gather_cols`). Outside a region both are the identity, so
single-device serving is untouched.

Not ported, because eager PyTorch has nothing they would act on: the
reference's ``constrain_qkv`` / ``constrain_tokens`` / ``constrain_decode_q``
are GSPMD layout hints (``with_sharding_constraint`` on a traced value),
and its ``compat.py`` shims JAX versions.

Every collective issued is counted (:func:`collective_counts`): a forward
of an L-layer model issues L + L all-reduces and one all-gather, 2L + 1;
:func:`collective_bytes` adds up each one's result buffer (an all-reduce's
buffer, an all-gather's gathered tensor), the sizes the dry run's rules
predict (``launch/dryrun.py::collectives_of``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.distributed as dist

_REGIONS: List = []  # the meshes of the active TP regions, innermost last
_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
_BYTES: Dict[str, int] = dict(_COUNTS)


def tp_mesh():
    """The mesh (``parallel/tp.py::TPMesh``) of the innermost active TP
    region, or None outside one."""
    return _REGIONS[-1] if _REGIONS else None


@contextlib.contextmanager
def tp_shard_region(mesh):
    """Run the enclosed model code as one rank of ``mesh``'s group."""
    _REGIONS.append(mesh)
    try:
        yield
    finally:
        _REGIONS.pop()


def collective_counts() -> Dict[str, int]:
    """Collectives issued by this process since the last reset, by kind."""
    return dict(_COUNTS)


def collective_bytes() -> Dict[str, int]:
    """The result bytes of the collectives issued since the last reset, by kind."""
    return dict(_BYTES)


def reset_collective_counts() -> None:
    for key in _COUNTS:
        _COUNTS[key] = 0
        _BYTES[key] = 0


def psum_partial(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) a row-parallel partial sum across the region's
    ranks, in ``x``'s dtype (the dtype the linear returns, as the
    reference's ``psum`` sums); the identity outside a region."""
    mesh = tp_mesh()
    if mesh is None:
        return x
    x = x.contiguous()
    _COUNTS["all_reduce"] += 1
    _BYTES["all_reduce"] += x.nbytes
    dist.all_reduce(x)
    return x


def all_gather_cols(x: torch.Tensor) -> torch.Tensor:
    """Concatenate the ranks' column shards (the vocab-split logits) along
    the last dim in rank order; the identity outside a region."""
    mesh = tp_mesh()
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    _COUNTS["all_gather"] += 1
    _BYTES["all_gather"] += x.nbytes * mesh.size
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=-1)


def agree(mesh, value: float) -> float:
    """Rank 0's ``value`` on every rank of ``mesh`` (a host decision, such
    as the serve loop's clock, that every rank must take alike)."""
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    _COUNTS["broadcast"] += 1
    _BYTES["broadcast"] += t.nbytes
    dist.broadcast(t, src=0)
    return float(t.item())
