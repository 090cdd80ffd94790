"""K12: a bank of experts' packed products in one launch,
``out[e] = x[e] @ W_e`` for every expert e of an MoE bank.

Replaces no ``pallas_call``: the reference's expert path
(``src/repro/models/moe.py``, ``_w`` and the grouped einsums of
``_moe_apply_global``) dequantizes each packed bank to the compute dtype in
plain jnp and leaves the einsums to XLA. On the card that round trip would
write and read a dense bf16 copy of every bank each step (805 MB a layer of
olmoe-1b-7b), so the port gives the computation a kernel of its own, as it
does the reference's ``lax.scan`` recurrences (K9-K11).

The CUDA kernel is the group-table skeleton of K1 / K5 / K4's CUDA-core
path (``csrc/grouptable.cuh``, ``expert_grouptable_kernel``) with the
expert index folded into the grid's third dimension beside the k-chunks:
each block offsets x, the planes, the scales, the output, the split's
scratch and its tickets by its expert's stride and then runs K1's block on
that expert. Every expert takes the plan ``grouptable.plan`` makes for one
expert (it depends on no batch or expert count), so each expert's rows get
exactly the bits the format's kernel gives when called on that expert
alone. What bounds it is what bounds K1: at decode capacities (8 rows an
expert) the bank's planes and scales, read once.

Formats: ``bcq`` (K1's table), ``uniform`` (K5's) and ``ternary`` (K4's
group-table path: f32 x or f32 alpha; bf16 with bf16 alpha takes K4's
tensor cores expert by expert, ``kernels/ops.py::expert_matmul``).

:func:`expert_mm` launches the kernel for CUDA tensors (or raises) and runs
:func:`expert_mm_plain` for CPU tensors. ``expert_mm.launches`` counts
kernel launches: one a bank at decode capacities, one a slab of every
expert's rows where the bank's split scratch would pass
``grouptable.SCRATCH_CAP`` (``grouptable.Plan.slab_rows``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import grouptable
from repro_torch.kernels._common import validate
from repro_torch.kernels.bcq_mm import bcq_mm_plain
from repro_torch.kernels.ternary_mm import PLANES as TERNARY_PLANES
from repro_torch.kernels.ternary_mm import ternary_mm_plain
from repro_torch.kernels.uniform_mm import uniform_mm_plain

KINDS = ("bcq", "uniform", "ternary")
_PLAIN = {"bcq": bcq_mm_plain, "uniform": uniform_mm_plain, "ternary": ternary_mm_plain}


def _validate(kind: str, x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"expert_mm: kind {kind!r}; the group-table kinds are {KINDS}")
    if x.dim() != 3 or packed.dim() != 4 or scales.dim() != 4:
        raise ValueError(
            f"expected x (E, C, k), packed (E, P, k/8, o) and scales (E, S, k/g, o); got "
            f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scales.shape)}"
        )
    if not x.shape[0] == packed.shape[0] == scales.shape[0]:
        raise ValueError(f"expert counts differ: x {x.shape[0]}, packed {packed.shape[0]}, scales {scales.shape[0]}")
    if kind == "ternary" and packed.shape[1] != TERNARY_PLANES:
        raise ValueError(f"ternary packed tensor must carry exactly {TERNARY_PLANES} planes, got {packed.shape[1]}")
    # one expert's view carries every check the single-expert kernels make
    validate(x[0], packed[0], scales[0], g, scale_planes=grouptable.SCALE_PLANES[kind])


def expert_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int,
                    kind: str = "bcq") -> torch.Tensor:
    """The plain PyTorch version: the format's plain kernel on each expert."""
    plain = _PLAIN[kind]
    return torch.stack([plain(x[e], packed[e], scales[e], g=g) for e in range(x.shape[0])])


def expert_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int,
              kind: str = "bcq") -> torch.Tensor:
    """x (E, C, k) @ E experts' [(E, P, k/8, o) planes, (E, S, k/g, o) scales]
    of format ``kind`` → (E, C, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`expert_mm_plain`.
    """
    _validate(kind, x, packed, scales, g)
    if not x.is_cuda:
        return expert_mm_plain(x, packed, scales, g=g, kind=kind)
    out, n = grouptable.launch_grouped(kind, x, packed, scales, g)
    expert_mm.launches += n
    return out


expert_mm.launches = 0
