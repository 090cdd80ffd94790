"""The RG-LRU scan (K9): ``h_t = a_t · h_{t-1} + g_t`` over a sequence,
keeping the whole state trajectory.

It replaces no ``pallas_call``: it is the port's counterpart of the
reference's ``lax.scan`` over the RG-LRU state
(``src/repro/models/recurrent.py:83-92``), which as eager PyTorch on the
card would be S steps of two elementwise launches a layer. The CUDA kernel
is ``csrc/rglru_scan.cu`` (:func:`plan`): past a short sequence, one block
per (batch row, 32 channels), a producer warp keeping a ring of
[32 steps × 32 channels] tiles of ``a`` and ``g`` in shared memory ahead of
the warp that walks the steps (TMA boxes, or per-element ``cp.async`` where
a row is not a 16-byte multiple); a short sequence, one thread per
(batch row, channel) straight from device memory. Both round the product
and the sum separately, so every path equals :func:`rglru_scan_plain` bit
for bit, and a scan of S steps equals S decode steps (S = 1).

:func:`rglru_scan` launches the kernel for CUDA tensors (or raises: there
is no fallback) and runs :func:`rglru_scan_plain` for CPU tensors.
``rglru_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import forward_only

SHORT_THREADS = 256  # threads a short-kernel block, one a channel (csrc: kShortThreads)
SLICE = 32  # channels a ring block: one warp's lanes (csrc: kSlice)
STEPS = 32  # steps a ring stage holds (csrc: kSteps)
STAGES = 8


def smem_bytes(stages: int) -> int:
    """A ring block's shared memory (``csrc/rglru_scan.cu::ring_smem``):
    each stage ``a`` and ``g`` as [STEPS][SLICE] f32 and two mbarriers."""
    return stages * (2 * STEPS * SLICE * 4 + 16)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch shape for one width W: sequences of at most
    ``short`` steps take the short kernel (a thread per channel); longer
    ones the ring, a block per ``slice`` channels with ``stages`` stages of
    ``steps`` steps in ``smem`` bytes, filled by TMA when ``tma`` (rows of
    16-byte multiples), else by per-element ``cp.async`` in the same kernel.
    Every path computes the same bits."""

    W: int
    short: int
    slice: int
    steps: int
    stages: int
    smem: int
    tma: bool

    def grid(self, B: int) -> Tuple[int, int]:
        """The ring kernel's grid: (slices, rows)."""
        return (-(-self.W // self.slice), B)

    def path(self, S: int) -> str:
        """The kernel a launch of S steps runs: ``"short"`` or ``"ring"``."""
        return "short" if S <= self.short else "ring"

    def blocks(self, B: int, S: int) -> int:
        """Blocks of a launch of B rows and S steps, on :meth:`path`'s kernel."""
        if self.path(S) == "short":
            return -(-self.W // SHORT_THREADS) * B
        x, y = self.grid(B)
        return x * y


@functools.lru_cache(maxsize=None)
def plan(W: int) -> Plan:
    """32 channels a ring block, so recurrentgemma-9b's W = 4096 gives 128
    blocks at B = 1; eight stages of 32 steps (64 KB, seven stages, 56 KB, in
    flight ahead of the compute warp); sequences up to one stage run the
    short kernel; TMA where ``4 W`` is a multiple of 16. Depends on W alone,
    never on B or S."""
    if W < 0:
        raise ValueError(f"rglru_scan: W {W} must not be negative")
    return Plan(W=W, short=STEPS, slice=SLICE, steps=STEPS, stages=STAGES, smem=smem_bytes(STAGES),
                tma=W % 4 == 0)


def use_tma(pl: Plan, a: torch.Tensor, g: torch.Tensor) -> bool:
    """Whether a ring launch fills the ring by TMA: the plan's rows are
    16-byte multiples and ``a`` and ``g`` start on 16-byte boundaries; else
    the kernel's per-element ``cp.async`` path."""
    return pl.tma and a.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0


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
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
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
    forward_only("rglru_scan", a, g, h0)
    a, g, h0 = a.contiguous(), g.contiguous(), h0.contiguous()
    B, S, W = a.shape
    hs = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    pl = plan(W)
    tma = use_tma(pl, a, g)
    lib, fn = _entry()
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), g.data_ptr(), h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(), B, S, W, pl.short,
                pl.stages, int(tma), pl.smem, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, "rglru_scan launch")
    rglru_scan.launches += 1
    return hs, h_last


rglru_scan.launches = 0
