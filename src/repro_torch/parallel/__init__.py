"""Parallelism: the tensor-parallel region and its collectives (``ctx``),
the weight placement with the sharded forward (``tp``), and the mesh-axis
rules of every parameter, cache and batch tensor (``sharding``).
Counterpart of ``repro/parallel``.

A TP rank's KV cache is ``init_cache`` of ``TPContext.cfg_local`` (its own
kv heads), which is the reference's ``layout="heads"`` cache rule. The
mesh-axis rules' consumer is the dry run (``launch/dryrun.py``), which reads
from them what every rank of the production mesh holds and which
collectives a step needs; eager PyTorch has no GSPMD mesh that would place
tensors by them.
"""

from repro_torch.parallel.ctx import (
    all_gather_cols,
    collective_bytes,
    collective_counts,
    psum_partial,
    reset_collective_counts,
    tp_shard_region,
)
from repro_torch.parallel.sharding import (
    MeshAxes,
    Spec,
    batch_specs,
    cache_specs,
    logits_spec,
    multi_pod_axes,
    param_specs,
    qt_specs_like,
    single_pod_axes,
)
from repro_torch.parallel.tp import TPContext, TPMesh, make_tp_mesh, shard_model

__all__ = [
    "MeshAxes",
    "Spec",
    "TPContext",
    "TPMesh",
    "all_gather_cols",
    "batch_specs",
    "cache_specs",
    "collective_bytes",
    "collective_counts",
    "logits_spec",
    "make_tp_mesh",
    "multi_pod_axes",
    "param_specs",
    "psum_partial",
    "qt_specs_like",
    "reset_collective_counts",
    "shard_model",
    "single_pod_axes",
    "tp_shard_region",
]
