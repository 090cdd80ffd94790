"""LUT-GEMM: the paper's lookup-table quantized matmul (§III.B-C).

Replaces the TPU kernel ``src/repro/kernels/lutgemm.py::lutgemm``
(``_lutgemm_kernel``, ``_sign_patterns``). The CUDA kernel is
``csrc/lutgemm.cu``: per 128-row k tile it builds, in shared memory, a
256-entry table of partial sums for every 8-activation chunk and batch row,
then each thread walks its column's packed bytes and uses each byte directly
as the table key. The header note of the source says what bounds it and why
k is split across blocks (deterministically, with a second reduction launch);
the C side plans the split and sizes the scratch it needs.

:func:`lutgemm` launches the kernel for CUDA tensors and runs
:func:`lutgemm_plain`, the same table algorithm on tensors, for CPU tensors.
``lutgemm.launches`` counts launches of the table kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, validate

MU = packing.MU
_PLAIN_MAX_ELEMS = 1 << 27  # bounds the plain version's gathered (rows, k/8, o) block


def _sign_patterns(dtype, device) -> torch.Tensor:
    """(256, 8): patterns[key, j] = +1 if bit j (LSB-first) of key is set, else -1."""
    keys = torch.arange(1 << MU, device=device)[:, None]
    bits = (keys >> torch.arange(MU, device=device)[None, :]) & 1
    return (2 * bits - 1).to(dtype)


def lutgemm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The table algorithm on tensors, in f32: build ``LUT[b, c, key]``,
    retrieve by packed byte, sum g/8 chunks per group, scale, sum planes."""
    q, kc, o = packed.shape
    B = x.shape[0]
    lut = torch.matmul(
        x.to(torch.float32).reshape(B, kc, MU), _sign_patterns(torch.float32, x.device).T
    )  # (B, kc, 256)
    cpg = g // MU
    rows = torch.arange(kc, device=x.device)[:, None]
    keys = packed.long()
    out = torch.zeros((B, o), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_MAX_ELEMS // max(1, kc * o))
    for b0 in range(0, B, step):
        for i in range(q):
            part = lut[b0 : b0 + step, rows, keys[i]]  # (rows, kc, o)
            grouped = part.reshape(part.shape[0], kc // cpg, cpg, o).sum(dim=2)
            out[b0 : b0 + step] += torch.einsum(
                "bGo,Go->bo", grouped, scales[i].to(torch.float32)
            )
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lutgemm")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.lutgemm_workspace_bytes.argtypes = [i, i, i]
    lib.lutgemm_workspace_bytes.restype = n
    lib.lutgemm_launch.argtypes = [p, i, p, p, i, p, p, n, i, i, i, i, i, p]
    lib.lutgemm_launch.restype = i
    return lib


def lutgemm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """Paper-faithful LUT-GEMM: x (B, k) @ BCQ weights → (B, o) f32.

    Same contract as :func:`repro_torch.kernels.bcq_mm.bcq_mm`. A CUDA input
    launches the kernel (or raises); a CPU input runs :func:`lutgemm_plain`.
    """
    validate(x, packed, scales, g)
    if not x.is_cuda:
        return lutgemm_plain(x, packed, scales, g=g)
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    B, k = x.shape
    q, _, o = packed.shape
    out = torch.empty((B, o), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        nbytes = lib.lutgemm_workspace_bytes(B, k, o)  # split-k partials, planned in C
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
        rc = lib.lutgemm_launch(
            x.data_ptr(), DTYPE_CODES[x.dtype], packed.data_ptr(), scales.data_ptr(),
            DTYPE_CODES[scales.dtype], out.data_ptr(),
            workspace.data_ptr() if workspace is not None else None, nbytes,
            B, k, o, q, g, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, rc, "lutgemm launch")
    lutgemm.launches += 1
    return out


lutgemm.launches = 0
