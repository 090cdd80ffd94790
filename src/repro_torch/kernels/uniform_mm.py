"""Group-wise uniform int-q matmul consumed in packed form: ``y = x @ (s·C + z)``.

Replaces the TPU kernel ``src/repro/kernels/uniform_mm.py::uniform_mm``
(``uniform_mm_call``, ``_uniform_mm_kernel``, ``_unpack_codes_block``). The
CUDA kernel is ``csrc/uniform_mm.cu`` on K1's group-table skeleton
(``csrc/grouptable.cuh``, launched through
:mod:`repro_torch.kernels.grouptable`): the ``2^q`` weights ``c·s + z`` of
each (group, column) pair are built in shared memory from the staged scale
and zero, product and sum rounded apart as the plain version rounds them,
and looked up by each weight's q-bit code; the dense weight never reaches
device memory.

:func:`uniform_mm` launches the kernel for CUDA tensors and runs
:func:`uniform_mm_plain` for CPU tensors. ``uniform_mm.launches`` counts
kernel launches: one a row slab (``grouptable.Plan.slab_rows``).
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import uniform_dequantize
from repro_torch.kernels import grouptable
from repro_torch.kernels._common import forward_only, validate


def uniform_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: dequantize to f32 ``code·s + z``, multiply."""
    return torch.matmul(x.to(torch.float32), uniform_dequantize(packed, scales, g))


def uniform_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ uniform[(q, k/8, o) code planes, (2, k/g, o) scale/zero] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`uniform_mm_plain`.
    """
    validate(x, packed, scales, g, scale_planes=2)
    if not x.is_cuda:
        return uniform_mm_plain(x, packed, scales, g=g)
    forward_only("uniform_mm", x, scales)
    out, n = grouptable.launch("uniform", x, packed, scales, g)
    uniform_mm.launches += n
    return out


uniform_mm.launches = 0
