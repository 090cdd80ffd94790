"""Tensor-parallel serving: the TP region and its collectives (``ctx``) and
the weight placement with the sharded forward (``tp``). Counterpart of
``repro/parallel``'s serving part.

A rank's KV cache is ``init_cache`` of ``TPContext.cfg_local`` (its own kv
heads), which is the reference's ``layout="heads"`` cache rule. Not ported
yet (ROADMAP): ``repro/parallel/sharding.py``'s mesh axes and GSPMD training
and dry-run rules, which shard a batch and FSDP-split weights over several
axes; eager serving over one ``model`` axis needs none of them.
"""

from repro_torch.parallel.ctx import (
    all_gather_cols,
    collective_counts,
    psum_partial,
    reset_collective_counts,
    tp_shard_region,
)
from repro_torch.parallel.tp import TPContext, TPMesh, make_tp_mesh, shard_model

__all__ = [
    "TPContext",
    "TPMesh",
    "all_gather_cols",
    "collective_counts",
    "make_tp_mesh",
    "psum_partial",
    "reset_collective_counts",
    "shard_model",
    "tp_shard_region",
]
