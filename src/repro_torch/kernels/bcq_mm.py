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

import ctypes
import functools

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build

# dtype codes understood by the C entry points (csrc/common.cuh::DTypeCode)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def validate(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> None:
    """Shape, dtype and device checks shared by the BCQ kernels (the rules of
    the reference's ``_validate_tiling``: ``g % 8 == 0`` and ``k % g == 0``)."""
    if x.dim() != 2 or packed.dim() != 3 or scales.dim() != 3:
        raise ValueError(
            f"expected x (B, k), packed (q, k/8, o), scales (q, k/g, o); got "
            f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scales.shape)}"
        )
    _, k = x.shape
    q, kc, o = packed.shape
    if kc * packing.MU != k:
        raise ValueError(f"packed k dim {kc}*{packing.MU} != x k dim {k}")
    if g % packing.MU or k % g:
        raise ValueError(f"g={g} must be a multiple of {packing.MU} that divides k={k}")
    if tuple(scales.shape) != (q, k // g, o):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(q, k // g, o)}")
    if not 1 <= q <= 8:
        raise ValueError(f"q={q} planes; the kernels take 1..8")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    for name, t in (("x", x), ("scales", scales)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not (x.device == packed.device == scales.device):
        raise ValueError(
            f"x, packed and scales lie on different devices: "
            f"{x.device}, {packed.device}, {scales.device}"
        )


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bcq_mm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bcq_mm_launch.argtypes = [p, i, p, p, i, p, i, i, i, i, i, p]
    lib.bcq_mm_launch.restype = i
    return lib


def launch_bcq_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream (validated
    CUDA inputs) → ``(B, o)`` f32. Counts nothing; the public wrappers do."""
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    B, k = x.shape
    q, _, o = packed.shape
    out = torch.empty((B, o), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.bcq_mm_launch(
            x.data_ptr(), DTYPE_CODES[x.dtype], packed.data_ptr(), scales.data_ptr(),
            DTYPE_CODES[scales.dtype], out.data_ptr(), B, k, o, q, g,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, rc, "bcq_mm launch")
    return out


def bcq_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ BCQ[(q, k/8, o) packed, (q, k/g, o) scales] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`bcq_mm_plain`.
    """
    validate(x, packed, scales, g)
    if not x.is_cuda:
        return bcq_mm_plain(x, packed, scales, g=g)
    out = launch_bcq_mm(x, packed, scales, g)
    bcq_mm.launches += 1
    return out


bcq_mm.launches = 0
