"""Transformer building blocks (counterpart of ``repro/models/layers.py``,
for a dense decoder with an unwindowed KV cache in the compute dtype).

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
from repro_torch.kernels.ops import linear, linear_fused
from repro_torch.models.config import ModelConfig

NEG_INF = torch.finfo(torch.float32).min

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


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
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
        out = _sdpa(q, k, v, causal_mask(s, s, device=x.device))
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
        out = _sdpa(q, ck, cv, mask)
    return linear(out.reshape(b, s, cfg.q_dim), p["wo"]), cache


def mlp_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate_up" in p:
        w = p["w_gate_up"]
        d_ff = (w.o if isinstance(w, QuantizedTensor) else w.shape[-1]) // 2
        gate, up = linear_fused(x, w, (d_ff, d_ff))
    else:
        gate, up = linear(x, p["w_gate"]), linear(x, p["w_up"])
    return linear(torch.nn.functional.silu(gate) * up, p["w_down"])
