"""Transformer building blocks (counterpart of ``repro/models/layers.py``,
for a dense decoder with an unwindowed KV cache in the compute dtype).

Causal attention over the fresh sequence (train and prefill) goes through
:func:`_causal`: on the GPU the hand-written flash-attention kernel
(``kernels/flash_attn.py``), so the ``(S, S)`` logits never reach device
memory; on the CPU, and under ``impl_mode("ref")``, the reference's rule:
:func:`_sdpa` below :data:`LONG_SEQ_THRESHOLD` and the query-blocked
:func:`_sdpa_qchunked` from it on. Decode attention over the cache is
:func:`_sdpa_decode`, the same function written so that a batch row's
result does not depend on the batch (the reference has no kernel for it).
The plain attention, :func:`_sdpa` and :func:`causal_mask`, lives in
``kernels/ref.py``, where the kernel's plain version also takes it.

Every weight application goes through :func:`repro_torch.kernels.ops.linear`,
so any leaf may be a dense tensor or a packed QuantizedTensor.

Layouts match the reference: activations ``(B, S, D)``, heads
``(B, S, H, Dh)``, KV cache ``(B, S_max, Hkv, Dh)``.

Unlike the reference's functional cache update, :func:`_cache_write` writes
the new rows into the cache tensors in place and returns the same dict: the
cache is the largest activation-side buffer and copying it per step would
double its traffic.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.ops import current_impl_mode, linear, linear_fused
from repro_torch.kernels.ref import NEG_INF, causal_mask
from repro_torch.kernels.ref import sdpa as _sdpa
from repro_torch.models.config import ModelConfig

Pos = Union[int, torch.Tensor]


def _dense_init(gen: torch.Generator, shape, k: int, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(k))).to(dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, lead=(), device="cuda") -> dict:
    d, pd = cfg.d_model, cfg.pdtype
    return {
        "wq": _dense_init(gen, (*lead, d, cfg.q_dim), d, pd, device),
        "wk": _dense_init(gen, (*lead, d, cfg.kv_dim), d, pd, device),
        "wv": _dense_init(gen, (*lead, d, cfg.kv_dim), d, pd, device),
        "wo": _dense_init(gen, (*lead, cfg.q_dim, d), cfg.q_dim, pd, device),
    }


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead=(), device="cuda") -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {
        "w_gate": _dense_init(gen, (*lead, d, f), d, pd, device),
        "w_up": _dense_init(gen, (*lead, d, f), d, pd, device),
        "w_down": _dense_init(gen, (*lead, f, d), f, pd, device),
    }


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x (B, S, H, Dh); positions (B, S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _sdpa_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Decode attention of one new query row per batch row over the cache:
    the function of :func:`_sdpa` (f32 logits, probabilities rounded to V's
    dtype, f32 weighted sum), with each of the two products written as an
    elementwise product and a sum over its last axis. A batch row's result
    then does not depend on how many rows share the call: the library's
    batched GEMM behind ``einsum`` picks its algorithm, and so its order of
    summation, by the batch count, and a slot batch must decode each request
    exactly as a batch of one does (``infer/scheduler.py``). Each product
    writes and reads B·H·S_max·Dh f32 elements, G times the cache rows it
    reads. q (B,1,H,Dh); ck, cv (B,S_max,Hkv,Dh); mask (B or 1,1,1,S_max).
    """
    b, _, h, dh = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, hkv, h // hkv, 1, dh).to(torch.float32)
    keys = ck.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S_max, Dh)
    logits = (qg * keys).sum(-1) / math.sqrt(dh)  # (B, Hkv, G, S_max)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype).to(torch.float32)
    vals = cv.permute(0, 2, 3, 1)[:, :, None]  # (B, Hkv, 1, Dh, S_max)
    out = (probs[:, :, :, None, :] * vals).sum(-1)  # (B, Hkv, G, Dh)
    return out.reshape(b, 1, h, dh).to(q.dtype)


Q_CHUNK = 2048  # query-block length for long-sequence causal attention
LONG_SEQ_THRESHOLD = 8192


def _sdpa_qchunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int = Q_CHUNK) -> torch.Tensor:
    """Causal attention over query blocks of ``chunk`` rows: one
    ``(B, H, chunk, S)`` block of f32 logits is live at a time instead of
    ``(B, H, S, S)``. Falls back to one full :func:`_sdpa` when ``chunk``
    does not divide S, as the reference does."""
    b, s, h, dh = q.shape
    if s % chunk:
        return _sdpa(q, k, v, causal_mask(s, s, device=q.device))
    kpos = torch.arange(s, device=q.device)
    outs = []
    for i in range(s // chunk):
        qpos = i * chunk + torch.arange(chunk, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None]  # (1, 1, chunk, S)
        outs.append(_sdpa(q[:, i * chunk : (i + 1) * chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def _causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over the fresh sequence: the flash-attention kernel
    for a CUDA tensor unless ``impl_mode("ref")`` is in force; otherwise the
    reference's ``_causal`` rule (full :func:`_sdpa` below
    :data:`LONG_SEQ_THRESHOLD`, :func:`_sdpa_qchunked` from it on)."""
    if q.is_cuda and current_impl_mode() != "ref":
        return flash_attention(q, k, v)
    s = q.shape[1]
    if s >= LONG_SEQ_THRESHOLD:
        return _sdpa_qchunked(q, k, v)
    return _sdpa(q, k, v, causal_mask(s, s, device=q.device))


def _cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: Pos) -> dict:
    """Write ``s`` new K/V rows at absolute position ``pos`` (an int, a 0-d
    tensor, or a (B,) tensor of per-row positions), in place."""
    ck, cv = cache["k"], cache["v"]
    s = k.shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        rows = torch.arange(ck.shape[0], device=ck.device)[:, None]
        idx = pos.to(ck.device).long()[:, None] + torch.arange(s, device=ck.device)
        ck[rows, idx] = k.to(ck.dtype)
        cv[rows, idx] = v.to(cv.dtype)
        return cache
    p = int(pos)
    ck[:, p : p + s] = k.to(ck.dtype)
    cv[:, p : p + s] = v.to(cv.dtype)
    return cache


def attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    pos: Optional[Pos] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self-attention. Returns (out, cache).

    train    cache=None                  causal attention over x
    prefill  cache=empty, s > 1          as train, then writes the cache at pos
    decode   cache=filled, s == 1        writes row pos, attends the cache;
                                         ``pos`` is a scalar or a (B,) tensor
    """
    b, s, _ = x.shape
    if "wqkv" in p:
        q, k, v = linear_fused(x, p["wqkv"], (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    else:
        q, k, v = linear(x, p["wq"]), linear(x, p["wk"]), linear(x, p["wv"])
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.d_head), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.d_head), positions, cfg.rope_theta)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)

    if cache is None or s > 1:
        out = _causal(q, k, v)
        if cache is not None:
            cache = _cache_write(cache, k, v, pos)
    else:
        cache = _cache_write(cache, k, v, pos)
        ck, cv = cache["k"], cache["v"]
        slot = torch.arange(ck.shape[1], device=x.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            valid = slot[None, :] <= pos.to(x.device)[:, None]  # (B, S_max)
            mask = valid[:, None, None, :]
        else:
            mask = (slot <= int(pos))[None, None, None, :]
        out = _sdpa_decode(q, ck, cv, mask)
    return linear(out.reshape(b, s, cfg.q_dim), p["wo"]), cache


def mlp_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate_up" in p:
        w = p["w_gate_up"]
        d_ff = (w.o if isinstance(w, QuantizedTensor) else w.shape[-1]) // 2
        gate, up = linear_fused(x, w, (d_ff, d_ff))
    else:
        gate, up = linear(x, p["w_gate"]), linear(x, p["w_up"])
    return linear(torch.nn.functional.silu(gate) * up, p["w_down"])
