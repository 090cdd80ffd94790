"""Transformer building blocks (counterpart of ``repro/models/layers.py``,
for a dense decoder with an unwindowed KV cache, in the compute dtype or as
int8 codes with per-(token, head) scales).

Causal attention of a prompt (train, prefill, and a prefill chunk or
suffix at ``pos > 0``) goes through :func:`_causal`: on the GPU the
hand-written flash-attention kernel (``kernels/flash_attn.py``), so the
``(Sq, Sk)`` logits never reach device memory; on the CPU, and under
``impl_mode("ref")``, the reference's rule: :func:`_sdpa` below
:data:`LONG_SEQ_THRESHOLD` queries and the query-blocked
:func:`_sdpa_qchunked` from it on. A prefill at ``pos == 0`` attends its
fresh K/V; one at ``pos > 0`` first writes its rows into the cache, then
attends the cache's rows ``[0, pos + s)`` with its queries at positions
``pos .. pos + s - 1`` (the kernel's ``q_start``). The kernel gives a row
the same bits either way, so a prompt prefilled in chunks, or after a
cached prefix (``infer/prefix_cache.py``), gets the bits of the prompt
prefilled whole. :func:`gather_prefix_rows` and
:func:`install_prefix_rows` copy cache rows out to the prefix cache and
back. Decode attention over the cache is
:func:`_sdpa_decode`, the same function written so that a batch row's
result does not depend on the batch (the reference has no kernel for it);
a speculative verify (``attention(chunked=True)``) runs it once per chunk
token, so each token gets the bits of a decode step at its position.
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

An int8 cache (``ModelConfig.kv_cache_dtype == "int8"``) stores each K/V
vector as int8 codes and one f32 scale (:func:`_kv_quantize`, the
reference's arithmetic); every read of cached rows (decode, the chunked
verify, a prefill at ``pos > 0``) dequantizes them to the compute dtype
first (:func:`_cache_kv`), in plain PyTorch, as the reference does in XLA.
A prefill at ``pos == 0`` attends its fresh rows, not their codes.

Positions: a scalar ``pos`` is read on the host
(:func:`~repro_torch.utils.host_pos`, which raises under CUDA graph
capture); a ``(B,)`` tensor stays on the device and gives a row the same
bits, so a captured step (``infer/graphs.py``) takes that path.
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
from repro_torch.utils import host_pos, in_prompt_rows, row_sum, tree_map, tree_map_with_path

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
    """RMS norm over the last axis; the mean of squares is a
    :func:`~repro_torch.utils.row_sum`, so a row's bits do not depend on how
    many rows share the call (a decode step of B rows and a speculative
    verify of B·(γ+1) rows normalise a row alike)."""
    xf = x.to(torch.float32)
    var = row_sum(xf * xf) / xf.shape[-1]
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x (B, S, H, Dh); positions (B, S)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exps)
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


def _sdpa_qchunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int = Q_CHUNK, q_start: int = 0
) -> torch.Tensor:
    """Causal attention over query blocks of ``chunk`` rows, the queries at
    positions ``q_start ..`` over ``Sk = q_start + Sq`` keys: one
    ``(B, H, chunk, Sk)`` block of f32 logits is live at a time instead of
    ``(B, H, Sq, Sk)``. Falls back to one full :func:`_sdpa` when ``chunk``
    does not divide Sq, as the reference does."""
    s, sk = q.shape[1], k.shape[1]
    if s % chunk:
        return _sdpa(q, k, v, causal_mask(s, sk, device=q.device))
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for i in range(s // chunk):
        qpos = q_start + i * chunk + torch.arange(chunk, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None]  # (1, 1, chunk, Sk)
        outs.append(_sdpa(q[:, i * chunk : (i + 1) * chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def _causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_start: int = 0) -> torch.Tensor:
    """Causal attention of queries at positions ``q_start .. q_start + Sq -
    1`` over ``Sk = q_start + Sq`` keys: the flash-attention kernel for a
    CUDA tensor unless ``impl_mode("ref")`` is in force; otherwise the
    reference's ``_causal`` rule (full :func:`_sdpa` below
    :data:`LONG_SEQ_THRESHOLD` queries, :func:`_sdpa_qchunked` from it on)."""
    if q.is_cuda and current_impl_mode() != "ref":
        return flash_attention(q, k, v, q_start)
    s = q.shape[1]
    if s >= LONG_SEQ_THRESHOLD:
        return _sdpa_qchunked(q, k, v, q_start=q_start)
    return _sdpa(q, k, v, causal_mask(s, k.shape[1], device=q.device))


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., Dh)`` → int8 codes ``(..., Dh)`` and f32 scales ``(...)``, one
    per vector, in the reference's order (``_kv_quantize``): the scale is the
    f32 absmax over Dh, the codes ``round(x / max(scale, 1e-8) * 127)``
    (half to even, as ``jnp.round``) clipped to ±127."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1)
    q = torch.round(xf / torch.clamp_min(scale, 1e-8)[..., None] * 127.0).clamp(-127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Codes and scales back to ``dtype``: ``(q * (scale / 127)).to(dtype)``
    in f32, the reference's order."""
    return (q.to(torch.float32) * (scale[..., None] / 127.0)).to(dtype)


def _cache_kv(cache: dict, dtype, rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V rows ``[0, rows)`` (all of them when None) that attention
    reads: views of the cache leaves, or for an int8 cache their
    dequantization to ``dtype``."""
    ck, cv = cache["k"][:, :rows], cache["v"][:, :rows]
    if "k_scale" not in cache:
        return ck, cv
    return (_kv_dequantize(ck, cache["k_scale"][:, :rows], dtype),
            _kv_dequantize(cv, cache["v_scale"][:, :rows], dtype))


def _cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: Pos) -> dict:
    """Write ``s`` new K/V rows at absolute position ``pos`` (an int, a 0-d
    tensor, or a (B,) tensor of per-row positions), in place; an int8
    cache takes their codes and scales (:func:`_kv_quantize`)."""
    new = {"k": k, "v": v}
    if "k_scale" in cache:
        new["k"], new["k_scale"] = _kv_quantize(k)
        new["v"], new["v_scale"] = _kv_quantize(v)
    s = k.shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        dev = cache["k"].device
        rows = torch.arange(cache["k"].shape[0], device=dev)[:, None]
        idx = pos.to(dev).long()[:, None] + torch.arange(s, device=dev)
        for name, val in new.items():
            cache[name][rows, idx] = val.to(cache[name].dtype)
        return cache
    p = host_pos(pos)
    for name, val in new.items():
        cache[name][:, p : p + s] = val.to(cache[name].dtype)
    return cache


def gather_prefix_rows(cache: dict, start: int, n: int) -> dict:
    """A copy of rows ``[start, start + n)`` of every leaf of a model cache
    (``(repeat, B, S_max, Hkv, Dh)`` → ``(repeat, B, n, Hkv, Dh)``; an int8
    cache's scales ``(repeat, B, S_max, Hkv)`` alike), in the cache's tree:
    a committed prefix block. A copy, never a view:
    a view would keep the whole cache alive and change with its next
    write."""
    return tree_map(lambda leaf: leaf[:, :, start : start + n].clone(), cache)


def install_prefix_rows(cache: dict, rows: dict) -> dict:
    """Write gathered prefix rows (:func:`gather_prefix_rows`'s tree, ``L``
    rows a leaf) into rows ``[0, L)`` of every K/V leaf of ``cache``, in
    place; returns ``cache``."""

    def write(path, leaf):
        rw = rows
        for key in path:
            rw = rw[key]
        leaf[:, :, : rw.shape[2]] = rw.to(leaf.dtype)
        return leaf

    tree_map_with_path(write, cache)
    return cache


def token_rows_view(x: torch.Tensor) -> torch.Tensor:
    """``(B, s, d)`` → ``(B·s, 1, d)``: each of a chunk's tokens as a row of
    its own (:func:`~repro_torch.utils.token_rows`), so the linears sum it
    exactly as they sum a decode step's row."""
    return x.reshape(-1, 1, x.shape[-1])


def _chunk_decode(q: torch.Tensor, cache: dict, pos: Pos) -> torch.Tensor:
    """Chunked decode (a speculative verify): query ``i`` of ``s`` attends
    the cache at position ``pos + i`` under its own mask, through one
    :func:`_sdpa_decode` call per chunk token, so each gets the bits of a
    single-token decode step at that position over the same cache. q
    (B, s, H, Dh) after the chunk's s K/V rows were written."""
    ck, cv = _cache_kv(cache, q.dtype)
    b, s = q.shape[:2]
    slot = torch.arange(ck.shape[1], device=q.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        base = pos.to(q.device)[:, None]  # (B, 1)
    else:
        base = torch.full((b, 1), host_pos(pos), device=q.device)
    outs = []
    for i in range(s):
        mask = (slot[None, :] <= base + i)[:, None, None, :]  # (B, 1, 1, S_max)
        outs.append(_sdpa_decode(q[:, i : i + 1], ck, cv, mask))
    return torch.cat(outs, dim=1)


def attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    pos: Optional[Pos] = None,
    chunked: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self-attention. Returns (out, cache).

    train    cache=None                  causal attention over x
    prefill  cache, s > 1                s prompt tokens at pos..pos+s-1: at
                                         pos == 0 causal attention over x,
                                         then the cache write; at pos > 0
                                         the cache write first, then the
                                         queries attend the cache's rows
                                         [0, pos+s) (a prompt chunk, or the
                                         suffix after a cached prefix);
                                         s == 1 takes this path too inside
                                         ``utils.prompt_rows`` (a one-token
                                         prompt or last chunk)
    decode   cache=filled, s == 1        writes row pos, attends the cache;
                                         ``pos`` is a scalar or a (B,) tensor
    chunked  cache=filled, chunked=True  s fresh tokens at pos..pos+s-1 (a
                                         speculative verify): all s rows are
                                         written, then token i attends the
                                         cache as a decode step at pos+i does;
                                         the linears see B·s token rows
    """
    b, s, _ = x.shape
    xr = token_rows_view(x) if chunked else x
    if "wqkv" in p:
        q, k, v = linear_fused(xr, p["wqkv"], (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    else:
        q, k, v = linear(xr, p["wq"]), linear(xr, p["wk"]), linear(xr, p["wv"])
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.d_head), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.d_head), positions, cfg.rope_theta)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)

    if chunked:
        cache = _cache_write(cache, k, v, pos)
        out = _chunk_decode(q, cache, pos)
        y = linear(token_rows_view(out.reshape(b, s, cfg.q_dim)), p["wo"])
        return y.reshape(b, s, -1), cache
    if cache is None:
        out = _causal(q, k, v)
    elif s > 1 or in_prompt_rows():
        start = host_pos(pos)
        if start == 0:
            out = _causal(q, k, v)
            cache = _cache_write(cache, k, v, 0)
        else:
            cache = _cache_write(cache, k, v, start)
            out = _causal(q, *_cache_kv(cache, q.dtype, start + s), q_start=start)
    else:
        cache = _cache_write(cache, k, v, pos)
        ck, cv = _cache_kv(cache, x.dtype)
        slot = torch.arange(ck.shape[1], device=x.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            valid = slot[None, :] <= pos.to(x.device)[:, None]  # (B, S_max)
            mask = valid[:, None, None, :]
        else:
            mask = (slot <= host_pos(pos))[None, None, None, :]
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
