"""The production mesh's axes (counterpart of ``repro/launch/mesh.py``).

The reference builds its production mesh from 512 host placeholder devices
(``jax.make_mesh``, ``make_mesh_from_axes``) and activates it as the ambient
GSPMD mesh (``set_mesh``), which the compiler then partitions every traced
value over. Eager PyTorch has neither: no compiler partitions a step, and a
process group needs real processes. The dry run (``launch/dryrun.py``)
needs only the mesh's axis names and sizes, so a mesh here is its
:class:`~repro_torch.parallel.sharding.MeshAxes` (``MeshAxes.ranks`` its
size), which starts no process and needs no device; ``make_mesh_from_axes``
and ``set_mesh`` have no counterpart.

The sizes are the reference's (16 × 16, or 2 × 16 × 16), so the two
packages' spec trees and per-rank bytes can be compared cell for cell.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import MeshAxes, multi_pod_axes, single_pod_axes


def production_axes(*, multi_pod: bool = False) -> MeshAxes:
    """16 × 16 ``("data", "model")`` (256 ranks), or 2 × 16 × 16 ``("pod",
    "data", "model")`` (512 ranks, 2 pods)."""
    return multi_pod_axes(2, 16, 16) if multi_pod else single_pod_axes(16, 16)
