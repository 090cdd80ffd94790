"""Group-wise binary-coding quantization (BCQ), paper §III.A (counterpart of
``repro/core/bcq.py``).

A weight ``W (k, o)``, used as ``y = x @ W``, is approximated

    W[k, o]  ≈  Σ_{i=1..q}  alpha_i[k // g, o] · b_i[k, o]

with ``b_i ∈ {-1, +1}`` and one scale shared by ``g`` consecutive weights
along the reduction dimension ``k``.

Shapes: binary int8 ``(q, k, o)``; scales f32 ``(q, k // g, o)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _check_args(k: int, q: int, g: int) -> None:
    if q < 1 or q > 8:
        raise ValueError(f"q must be in [1, 8], got {q}")
    if g < 8:
        raise ValueError(f"group size g must be >= 8 (paper §III.A), got {g}")
    if k % g != 0:
        raise ValueError(f"group size g={g} must divide the reduction dim k={k}")


def _sign(x: torch.Tensor) -> torch.Tensor:
    """sign with sign(0) := +1 so codes are always in {-1,+1}."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def quantize_bcq_greedy(w: torch.Tensor, q: int, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-greedy BCQ → ``(scales (q,G,o) f32, binary (q,k,o) int8)``.

    Per group, ``q`` times: ``b_i = sign(r)``, ``alpha_i = mean(|r|)`` (the
    optimal scale for that code), ``r -= alpha_i * b_i``.
    """
    k, o = w.shape
    _check_args(k, q, g)
    r = w.to(torch.float32).reshape(k // g, g, o)
    scales, binary = [], []
    for _ in range(q):
        b = _sign(r)
        alpha = torch.mean(torch.abs(r), dim=1)  # (G, o)
        r = r - alpha[:, None, :] * b
        scales.append(alpha)
        binary.append(b)
    scales_t = torch.stack(scales)
    binary_t = torch.stack(binary).reshape(q, k, o).to(torch.int8)
    return scales_t, binary_t


def _alpha_lstsq(w_g: torch.Tensor, b_g: torch.Tensor, ridge: float) -> torch.Tensor:
    """Least-squares refit of the scales given the codes.

    w_g (G, g, o); b_g (q, G, g, o). Solves per (G, o) the ridge-regularised
    normal equations. Returns (q, G, o). A singular system (collinear codes)
    gives non-finite scales, as the reference's solve does, instead of raising.
    """
    q = b_g.shape[0]
    btb = torch.einsum("iago,jago->aoij", b_g, b_g)  # (G, o, q, q)
    btw = torch.einsum("iago,ago->aoi", b_g, w_g)  # (G, o, q)
    eye = torch.eye(q, dtype=btb.dtype, device=btb.device)
    sol = torch.linalg.solve_ex(btb + ridge * eye, btw[..., None])[0][..., 0]
    return torch.movedim(sol, -1, 0)


def _sign_patterns(q: int, dtype, device) -> torch.Tensor:
    """(2^q, q): patterns[p, i] = +1 if bit i (LSB-first) of p is set, else -1."""
    idx = torch.arange(1 << q, device=device)[:, None]
    bits = (idx >> torch.arange(q, device=device)[None, :]) & 1
    return (2.0 * bits - 1.0).to(dtype)


def _bits_step(w_g: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Exhaustive re-selection of codes given scales: every weight picks the
    pattern in {-1,+1}^q closest to it. w_g (G, g, o); scales (q, G, o).
    Returns codes (q, G, g, o)."""
    q = scales.shape[0]
    patterns = _sign_patterns(q, w_g.dtype, w_g.device)  # (2^q, q)
    cand = torch.einsum("pi,iao->pao", patterns, scales)  # (2^q, G, o)
    dist = torch.abs(w_g[..., None] - torch.movedim(cand, 0, -1)[:, None, :, :])
    best = torch.argmin(dist, dim=-1)  # (G, g, o)
    return torch.movedim(patterns[best], -1, 0)


def quantize_bcq(
    w: torch.Tensor, q: int, g: int, iters: int = 10, col_chunk: int = 512
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy init + ``iters`` rounds of alternating optimisation (Xu et al.).

    ``col_chunk`` bounds the exhaustive bits step's ``(G, g, col_chunk, 2^q)``
    distance tensor by solving output-column chunks one after another.

    Returns ``(scales (q,G,o) f32, binary (q,k,o) int8)``.
    """
    k, o = w.shape
    _check_args(k, q, g)
    wf = w.to(torch.float32)

    col_chunk = min(col_chunk, o)
    if o % col_chunk != 0:
        col_chunk = math.gcd(o, col_chunk) or o

    scales_c, binary_c = [], []
    for start in range(0, o, col_chunk):
        w_chunk = wf[:, start : start + col_chunk]
        oo = w_chunk.shape[1]
        scales, binary0 = quantize_bcq_greedy(w_chunk, q, g)
        w_g = w_chunk.reshape(k // g, g, oo)
        codes = binary0.to(torch.float32).reshape(q, k // g, g, oo)
        for _ in range(iters):
            scales = _alpha_lstsq(w_g, codes, ridge=1e-8)
            codes = _bits_step(w_g, scales)
        scales_c.append(scales)
        binary_c.append(codes.reshape(q, k, oo).to(torch.int8))
    return torch.cat(scales_c, dim=-1), torch.cat(binary_c, dim=-1)


def dequantize(scales: torch.Tensor, binary: torch.Tensor, g: int) -> torch.Tensor:
    """Reconstruct ``W ≈ Σ_i alpha_i ∘ b_i`` → (..., k, o) f32.

    binary ``(..., q, k, o)``, scales ``(..., q, k//g, o)``.
    """
    *lead, q, k, o = binary.shape
    b = binary.to(torch.float32).reshape(*lead, q, k // g, g, o)
    w = torch.einsum("...iago,...iao->...ago", b, scales.to(torch.float32))
    return w.reshape(*lead, k, o)


def bcq_error(w: torch.Tensor, scales: torch.Tensor, binary: torch.Tensor, g: int) -> torch.Tensor:
    """Relative Frobenius reconstruction error ||W - Ŵ|| / ||W||."""
    wf = w.to(torch.float32)
    w_hat = dequantize(scales, binary, g)
    return torch.linalg.norm(wf - w_hat) / (torch.linalg.norm(wf) + 1e-12)


def compression_ratio(q: int, g: int, base_bits: int = 16, scale_bits: int = 16) -> float:
    """Paper Eq. (3): bits per weight of a ``base_bits`` dense format over BCQ's
    ``q`` binary bits plus ``scale_bits / g`` amortised scale bits."""
    bcq_bits = q * (1.0 + scale_bits / g)
    return base_bits / bcq_bits
