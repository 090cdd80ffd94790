"""BCQ matmul consumed in packed form: ``y = x @ Σ_i alpha_i ∘ b_i``.

Replaces the TPU kernel ``src/repro/kernels/bcq_mm.py::bcq_mm`` (its
``pallas_call`` in ``bcq_mm_call``). The CUDA kernel is ``csrc/bcq_mm.cu``
on the group-table skeleton ``csrc/grouptable.cuh``, launched through
:mod:`repro_torch.kernels.grouptable` (its plan and its note say what bounds
it and how the design answers that). In short: the ``2^q`` weights a
(group, column) pair can take, ``±alpha_0 ± … ± alpha_{q-1}`` folded in
plane order, are built in shared memory from the staged scales and looked
up by each weight's q-bit code; x · w is accumulated in f32 and the
k-split's partial sums are added in a fixed order.

:func:`bcq_mm` launches the kernel for CUDA tensors and runs
:func:`bcq_mm_plain` for CPU tensors. ``bcq_mm.launches`` counts kernel
launches: one a call at decode widths, one a row slab where a call is wider
than a slab (``grouptable.Plan.slab_rows``, prefill widths).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import grouptable
from repro_torch.kernels._common import validate


def bcq_weight_plain(packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """``(k, o)`` f32 w_eff: the planes unpacked to ±1, the group scales
    expanded over g rows, summed plane by plane in order."""
    q = packed.shape[0]
    signs = packing.unpack_signs(packed)  # (q, k, o) int8
    w = None
    for i in range(q):  # one plane at a time bounds the f32 temporaries
        wi = signs[i].to(torch.float32) * scales[i].to(torch.float32).repeat_interleave(g, dim=0)
        w = wi if w is None else w + wi
    return w


def bcq_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: :func:`bcq_weight_plain`, then a matmul in f32."""
    return torch.matmul(x.to(torch.float32), bcq_weight_plain(packed, scales, g))


def bcq_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ BCQ[(q, k/8, o) packed, (q, k/g, o) scales] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`bcq_mm_plain`.
    """
    validate(x, packed, scales, g)
    if not x.is_cuda:
        return bcq_mm_plain(x, packed, scales, g=g)
    out, n = grouptable.launch("bcq", x, packed, scales, g)
    bcq_mm.launches += n
    return out


bcq_mm.launches = 0
