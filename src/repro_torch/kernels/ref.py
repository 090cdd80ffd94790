"""Oracles for the kernels (counterpart of ``repro/kernels/ref.py``), and the
plain attention (counterpart of ``repro/models/layers.py``'s ``_sdpa`` and
``causal_mask``), which is the flash-attention kernel's plain version and
which ``models/layers.py`` runs where the kernel does not."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import bcq as bcq_lib
from repro_torch.core import packing


def bcq_mm_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """Oracle for ``bcq_mm`` and ``lutgemm``: ``y = x @ dequantize(W)``.

    x (B, k); packed (q, k//8, o) uint8; scales (q, k//g, o). Returns (B, o) f32.
    """
    signs = packing.unpack_signs(packed)
    w = bcq_lib.dequantize(scales.to(torch.float32), signs, g)
    return torch.matmul(x.to(torch.float32), w)


def lutgemm_tablewise_ref(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int
) -> torch.Tensor:
    """Slow f64 emulation of the LUT algorithm (paper §III.B, Table II): a
    2^mu-entry table per mu-length activation sub-vector, partial sums
    retrieved by packed-byte key, group scales applied, summed over planes.
    Returns (B, o) f64."""
    mu = packing.MU
    q, kc, o = packed.shape
    b = x.shape[0]
    x = x.to(torch.float64)
    scales = scales.to(torch.float64)

    keys = torch.arange(1 << mu, device=x.device)
    patterns = 2.0 * ((keys[:, None] >> torch.arange(mu, device=x.device)[None, :]) & 1) - 1.0
    lut = torch.einsum("pj,bcj->bcp", patterns.to(torch.float64), x.reshape(b, kc, mu))

    out = torch.zeros((b, o), dtype=torch.float64, device=x.device)
    cpg = g // mu
    rows = torch.arange(kc, device=x.device)[:, None]
    for i in range(q):
        part = lut[:, rows, packed[i].long()]  # (b, kc, o)
        grouped = part.reshape(b, kc // cpg, cpg, o).sum(dim=2)
        out += torch.einsum("bGo,Go->bo", grouped, scales[i])
    return out


NEG_INF = torch.finfo(torch.float32).min  # the reference's mask value


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """GQA softmax attention in plain torch. q (B,Sq,H,Dh); k, v (B,Sk,Hkv,Dh)
    with H = G·Hkv; mask broadcastable to (..., Sq, Sk) or None.

    Queries are grouped (B,Sq,Hkv,G,Dh) against the raw Hkv heads, so
    repeated K/V heads are never materialised; logits, softmax and the
    weighted sum accumulate in f32, with the probabilities rounded to V's
    dtype first, as the reference does.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(dh)
    if mask is not None:
        m = mask[..., None, :, :] if mask.dim() == 4 else mask
        logits = torch.where(m, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.reshape(b, sq, h, dh).to(q.dtype)


def causal_mask(sq: int, sk: int, device=None) -> torch.Tensor:
    """(1, 1, sq, sk) boolean causal mask (query i sees keys <= i + sk - sq)."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=device)[None, :]
    return (ki <= qi)[None, None]
