"""Causal GQA softmax attention with an online softmax (flash attention).

Replaces the TPU kernel ``src/repro/kernels/flash_attn.py::flash_attention``
(its ``pallas_call`` over ``_flash_kernel``). The CUDA source is
``csrc/flash_attn.cu``; its header note says what bounds it on the H100 and
how the design answers that. It holds two kernels, chosen by dtype
(:func:`kernel_for`): bf16 runs on the tensor cores (``wgmma``, with TMA
copies of 128-key tiles in flight while the current tile is multiplied);
f32 runs on the CUDA cores, because the tensor cores have no f32 product
that holds the f32 check. Either way one block per (batch row, head, query
tile) walks the key tiles up to the diagonal with a running max, a running
denominator and an f32 accumulator, so the ``(S, S)`` logits never reach
device memory.

q is ``(B, S, H, Dh)``, k and v ``(B, S, Hkv, Dh)`` with ``H % Hkv == 0``
(head h reads kv head ``h // (H / Hkv)``), all f32 or all bf16, and the
result is ``(B, S, H, Dh)`` in q's dtype. Any ``S >= 1`` is accepted: the
kernel masks the ragged end itself (the reference's rule that S divide the
TPU block sizes is a tiling rule of that chip, not of the function).
``Dh`` must be one of :data:`HEAD_DIMS`, the kernel's template set. The
bf16 kernel's TMA copies read q, k and v through their strides, which must
be 16-byte aligned (:func:`tma_ready`); the wrapper copies an input that is
not, and counts such copies in ``flash_attention.copies``.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors. ``flash_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES
from repro_torch.kernels.ref import causal_mask, sdpa

HEAD_DIMS = (16, 32, 64, 128)

# The bf16 kernel against its plain version, per query row (b, s, h):
# max|out - plain| over the row's Dh values, over the row's max|plain|. Both
# round their f32 result to bf16 at the end, so a correct kernel is one bf16
# ulp off where the two straddle a rounding boundary, at most 2^-7 of the
# row's largest value; rounding exp(s - m) per key tile instead of the
# normalised probabilities adds about 2^-9 of the terms' sum. The limit is
# twice the ulp. An absolute limit (the reference test's 3e-2) would not see
# the long rows, whose values shrink as 1/sqrt(S).
BF16_ROW_TOL = 2.0**-6


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the plain attention under a causal mask
    (the reference's oracle for its kernel), with the full ``(S, S)``
    logits."""
    s = q.shape[1]
    return sdpa(q, k, v, causal_mask(s, s, device=q.device))


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest, over query rows, of max|out - ref| / max|ref| across the
    row's last (head) dim; the measure :data:`BF16_ROW_TOL` bounds."""
    err = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / scale).max().item()


def validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Rank 4, matching B, S and Dh, ``H % Hkv == 0``, k and v alike, Dh in
    :data:`HEAD_DIMS`, one float dtype and one device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"expected q (B, S, H, Dh) and k, v (B, S, Hkv, Dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, dh = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, dh):
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} must agree on B, S and Dh"
        )
    hkv = k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} query heads must be a multiple of Hkv={hkv} kv heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} is not one of the kernel's {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share one dtype, float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on different devices: {q.device}, {k.device}, {v.device}")


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("flash_attn")
    fn = lib.flash_attn_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i] + [ll] * 12 + [p]
    fn.restype = i
    return lib, fn


def kernel_for(dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/flash_attn.cu`` serves ``dtype``:
    ``"tensor_cores"`` (bf16) or ``"cuda_cores"`` (f32)."""
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "cuda_cores"
    raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA copies can read ``t`` (B, S, heads, Dh)
    in place: head dim contiguous, a 16-byte aligned base, and 16-byte
    multiples for the strides of the other dims (a dim of size 1 is read at
    index 0 only, so its stride does not matter)."""
    size = t.element_size()
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all((t.stride(i) * size) % 16 == 0 for i in range(3) if t.shape[i] > 1)
    )


def _kernel_input(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel for its dtype can read it: the head dim
    contiguous, and for bf16 :func:`tma_ready` (else a fresh aligned copy,
    counted in ``flash_attention.copies``)."""
    if kernel_for(t.dtype) == "cuda_cores":
        return t if t.stride(-1) == 1 else t.contiguous()
    if tma_ready(t):
        return t
    flash_attention.copies += 1
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention: q (B, S, H, Dh), k, v (B, S, Hkv, Dh) → (B, S, H, Dh)
    in q's dtype. A CUDA input launches the kernel (or raises); a CPU input
    runs :func:`flash_attention_plain`."""
    validate(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    q, k, v = _kernel_input(q), _kernel_input(k), _kernel_input(v)
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
            b, s, h, k.shape[2], dh, *strides, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attn launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.copies = 0
