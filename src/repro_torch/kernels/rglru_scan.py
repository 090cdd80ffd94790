"""The RG-LRU scan (K9): ``h_t = a_t · h_{t-1} + g_t`` over a sequence,
keeping the whole state trajectory.

It replaces no ``pallas_call``: it is the port's counterpart of the
reference's ``lax.scan`` over the RG-LRU state
(``src/repro/models/recurrent.py:83-92``), which as eager PyTorch on the
card would be S steps of two elementwise launches a layer. The CUDA kernel
is ``csrc/rglru_scan.cu``: one thread per (batch row, channel), adjacent
threads on adjacent channels, a sequential loop over S with the product
and the sum rounded separately, so it equals :func:`rglru_scan_plain` bit
for bit, and a scan of S steps equals S decode steps (S = 1).

:func:`rglru_scan` launches the kernel for CUDA tensors (or raises: there
is no fallback) and runs :func:`rglru_scan_plain` for CPU tensors.
``rglru_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build


def rglru_scan_plain(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``h = a_t * h; h = h + g_t`` for t in
    order → (hs (B, S, W), h_last (B, W)), all f32."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h
        h = h + g[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1) if hs else a.new_zeros(a.shape)
    return hs, h


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, p]
    fn.restype = i
    return lib, fn


def rglru_scan(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a``, ``g`` (B, S, W) f32, ``h0`` (B, W) f32 → ``hs`` (B, S, W), the
    state after each token, and ``h_last`` (B, W), the state after the last
    (``h0`` when S = 0).

    A CUDA input launches the kernel (or raises); a CPU input runs
    :func:`rglru_scan_plain`.
    """
    if a.dim() != 3 or g.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, g {tuple(g.shape)} and h0 {tuple(h0.shape)} "
                         "must be (B, S, W), (B, S, W) and (B, W)")
    for name, t in (("a", a), ("g", g), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} must be float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, a on {a.device}")
    if not a.is_cuda:
        return rglru_scan_plain(a, g, h0)
    a, g, h0 = a.contiguous(), g.contiguous(), h0.contiguous()
    B, S, W = a.shape
    hs = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    lib, fn = _entry()
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(), B, S, W,
                torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, "rglru_scan launch")
    rglru_scan.launches += 1
    return hs, h_last


rglru_scan.launches = 0
