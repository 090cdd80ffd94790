"""Dequantize-then-matmul, the paper's baseline (OPTQ / nuQmm recipe, paper
Table 3 / Fig. 9), on ``uniform``'s packing.

Replaces the TPU kernel ``src/repro/kernels/dequant_mm.py::dequant_materialize``
(``_dequant_kernel``). The CUDA kernel is ``csrc/dequant_mm.cu``: one thread
per packed byte column reads the q plane bytes and the group's ``(s, z)``
and writes the 8 dense values ``code·s + z`` of its column, stores
coalesced along o. :func:`dequant_mm` then runs a stock GEMM on the
materialised weight (``torch.matmul`` in f32, as the reference's
``jnp.dot`` outside its ``pallas_call``): two dispatches and a dense-weight
round trip through device memory, the overhead the one-pass kernels avoid.
Told that its rows are one token each (a decode step), it runs that GEMM
in fixed tiles of rows (:func:`~repro_torch.utils.matmul_rows`), so each
row gets the bits of the row called alone.

:func:`dequant_materialize` launches the kernel for CUDA tensors and runs
:func:`dequant_materialize_plain` for CPU tensors.
``dequant_materialize.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import uniform_dequantize
from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, validate, validate_planes
from repro_torch.utils import matmul_rows


def dequant_materialize_plain(
    packed: torch.Tensor, scales: torch.Tensor, *, g: int, out_dtype=torch.float32
) -> torch.Tensor:
    """The plain PyTorch version: ``code·s + z`` in f32, cast to ``out_dtype``."""
    return uniform_dequantize(packed, scales, g).to(out_dtype)


def dequant_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain pipeline: materialise in f32, multiply in f32."""
    return torch.matmul(x.to(torch.float32), dequant_materialize_plain(packed, scales, g=g))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("dequant_mm")
    fn = lib.dequant_materialize_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, i, i, i, i, p]
    fn.restype = i
    return lib, fn


def dequant_materialize(
    packed: torch.Tensor, scales: torch.Tensor, *, g: int, out_dtype=torch.float32
) -> torch.Tensor:
    """Uniform planes ``(q, k/8, o)``, ``(2, k/g, o)`` scale/zero → the dense
    ``(k, o)`` weight in ``out_dtype`` (f32 or bf16), written to device memory.

    A CUDA input launches the kernel (or raises); a CPU input runs
    :func:`dequant_materialize_plain`.
    """
    validate_planes(packed, scales, g, scale_planes=2)
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not packed.is_cuda:
        return dequant_materialize_plain(packed, scales, g=g, out_dtype=out_dtype)
    packed, scales = packed.contiguous(), scales.contiguous()
    q, kc, o = packed.shape
    out = torch.empty((kc * 8, o), dtype=out_dtype, device=packed.device)
    lib, fn = _entry()
    with torch.cuda.device(packed.device):
        rc = fn(
            packed.data_ptr(), scales.data_ptr(), DTYPE_CODES[scales.dtype], out.data_ptr(),
            DTYPE_CODES[out_dtype], kc, o, q, g,
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _build.check(lib, rc, "dequant_materialize launch")
    dequant_materialize.launches += 1
    return out


dequant_materialize.launches = 0


def dequant_mm(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int, token_rows: bool = False
) -> torch.Tensor:
    """x (B, k) @ uniform-packed weights via materialise + dense f32 GEMM →
    (B, o) f32. Same contract as :func:`~repro_torch.kernels.uniform_mm.uniform_mm`;
    deliberately the slow way round: the paper's baseline, not a fast path.

    ``token_rows``: each row of x is one token of its own request (a decode
    step over B requests), so the GEMM runs as :func:`~repro_torch.utils.
    matmul_rows` runs such rows (one at a time on the CPU, in fixed tiles
    on the GPU) and a row's result does not depend on B. A prompt's rows
    (the default) are one product."""
    validate(x, packed, scales, g, scale_planes=2)
    w = dequant_materialize(packed, scales, g=g)
    if token_rows:
        return matmul_rows(x.to(torch.float32), w)
    return torch.matmul(x.to(torch.float32), w)
