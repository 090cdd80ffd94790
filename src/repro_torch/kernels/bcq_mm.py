"""BCQ matmul consumed in packed form: ``y = x @ Σ_i alpha_i ∘ b_i``.

Replaces the TPU kernel ``src/repro/kernels/bcq_mm.py::bcq_mm`` (its
``pallas_call`` in ``bcq_mm_call``). The CUDA kernel is
``csrc/bcq_mm.cu``; its header note says what bounds it on the H100 and how
the design answers that. In short: a block owns 32 output columns and loops
over all of k itself (deterministic, no atomics), expands sign bits to
``±alpha`` in registers and accumulates ``x · w_eff`` in f32.

:func:`bcq_mm` launches the kernel for CUDA tensors and runs
:func:`bcq_mm_plain` for CPU tensors. ``bcq_mm.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels._common import launch_matvec, validate


def bcq_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: unpack the planes to ±1, expand the group
    scales over g rows, sum the planes into w_eff (f32) and multiply."""
    q = packed.shape[0]
    signs = packing.unpack_signs(packed)  # (q, k, o) int8
    w = None
    for i in range(q):  # one plane at a time bounds the f32 temporaries
        wi = signs[i].to(torch.float32) * scales[i].to(torch.float32).repeat_interleave(g, dim=0)
        w = wi if w is None else w + wi
    return torch.matmul(x.to(torch.float32), w)


def bcq_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ BCQ[(q, k/8, o) packed, (q, k/g, o) scales] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`bcq_mm_plain`.
    """
    validate(x, packed, scales, g)
    if not x.is_cuda:
        return bcq_mm_plain(x, packed, scales, g=g)
    out = launch_matvec("bcq_mm", x, packed, scales, g)
    bcq_mm.launches += 1
    return out


bcq_mm.launches = 0
