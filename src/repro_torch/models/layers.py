"""Transformer building blocks (counterpart of ``repro/models/layers.py``,
for the dense decoder's unwindowed KV cache, the hybrid family's local
attention on a ring cache, each in the compute dtype or as int8 codes with
per-(token, head) scales, and the vlm family's cross-attention over a
provided image memory).

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

Local attention (``attention(window=W)``, the hybrid family's
``local_attn`` block): a query at position p sees the keys at positions
(p - W, p]. Its cache is a ring of ``s_max = min(max_seq, W)`` rows, row
``pos % s_max`` holding position pos (:func:`_ring_positions` says which
position a slot holds after a number of writes; a prefill longer than the
ring keeps its last ``s_max`` rows, rolled into their slots). Decode
attends the whole ring in slot order under the band mask, through
:func:`_sdpa_decode`, so a row's bits do not depend on the batch. A
speculative verify gives each token the keys a decode step at its position
sees, in the same order: the rows the chunk's later tokens overwrote are
put back in their slots for it (:func:`_chunk_decode`). A prefill attends
in blocks of :data:`LOCAL_Q_BLOCK` queries aligned to absolute positions,
each block one fixed-shape :func:`_sdpa` over the keys its band can reach
(:func:`_local_prefill`), so a prompt row gets the same bits whether the
prompt is prefilled whole or as the suffix after a cached prefix. None of
this takes the flash-attention kernel, which has no window and stops at
Dh = 128 (the reference computes local attention in plain XLA too);
training (no cache) runs the reference's :func:`_local_attention_chunked`.

Cross-attention (``attention(kv_override=(k_mem, v_mem))``, the vlm
family's ``cross`` block): the queries, RoPE'd at their token positions,
attend every row of a provided memory (the projected image tokens, which
get no RoPE) without a mask; ``wq`` and ``wo`` project the tokens, and the
block's ``wk`` / ``wv`` the image embeddings (``models/model.py``). A
prompt takes one :func:`_sdpa` over the memory, as the reference computes
it in plain XLA (no kernel: K8 is causal); a decode step and each token of
a speculative verify take :func:`_sdpa_decode` under an all-true mask
(:func:`_memory_decode`), so a verify's token gets a decode step's bits.

The cache-rewind contract (the reference's, ``repro/models/layers.py``):
every cache leaf is POSITIONAL (``k``, ``v`` and the int8 scales: rows at
absolute positions, or ring slots), RECURRENT (``h``, ``conv`` of the
RG-LRU; ``c``, ``n``, ``m`` of the mLSTM and ``h``, ``c``, ``n``, ``m`` of
the sLSTM: state that folds every token irreversibly,
``models/recurrent.py``) or STATIC (``k_img``, ``v_img`` of a ``cross``
block: the projected image memory, written once by a prefill given image
embeddings, never by a decode step or a verify, never rewound, and never
part of a prefix block: the prefix cache refuses vlm models). A name means
the same kind in every block, and everything keyed by leaf name works
whatever the leaf's shape. The prefix cache gathers and installs positional
rows (:func:`gather_prefix_rows`, :func:`install_prefix_rows`) and
snapshots recurrent state at block boundaries (:func:`snapshot_recurrent`,
:func:`install_recurrent`); each of them passes static leaves by.

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
from repro_torch.parallel.ctx import psum_partial
from repro_torch.utils import ROW_SUM_WIDTH, host_pos, in_prompt_rows, row_sum, tree_map, tree_map_with_path

Pos = Union[int, torch.Tensor]

POSITIONAL_CACHE_LEAVES = frozenset({"k", "v", "k_scale", "v_scale"})
RECURRENT_CACHE_LEAVES = frozenset({"h", "conv", "c", "n", "m"})
STATIC_CACHE_LEAVES = frozenset({"k_img", "v_img"})


def select_leaves(tree, names, fn=lambda leaf: leaf):
    """The subtree of ``tree`` whose leaves are named in ``names`` (a leaf's
    name is its dict key), each passed through ``fn``; other leaves are
    dropped, containers kept (a block without such leaves maps to ``{}``)."""
    if isinstance(tree, dict):
        out = {}
        for key, v in tree.items():
            if isinstance(v, (dict, tuple, list)):
                out[key] = select_leaves(v, names, fn)
            elif key in names:
                out[key] = fn(v)
        return out
    if isinstance(tree, (tuple, list)):
        return type(tree)(select_leaves(v, names, fn) for v in tree)
    raise TypeError(f"select_leaves: a bare leaf has no name ({type(tree).__name__})")


def walk_pairs(dst, src, fn) -> None:
    """``fn(name, dst_leaf, src_leaf)`` for every leaf of ``src`` (a subtree
    of ``dst``'s structure, e.g. :func:`select_leaves`'s)."""
    if isinstance(src, dict):
        for key, v in src.items():
            if isinstance(v, (dict, tuple, list)):
                walk_pairs(dst[key], v, fn)
            else:
                fn(key, dst[key], v)
    else:
        for d, v in zip(dst, src):
            walk_pairs(d, v, fn)


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
    elementwise product and a sum in stages of 32 (the logits' over Dh with
    :func:`~repro_torch.utils.row_sum`, the values' over S_max with
    :func:`_rows_sum`). A batch row's result then does not depend on how
    many rows share the call: the library's batched GEMM behind ``einsum``
    picks its algorithm, and so its order of summation, by the batch count,
    and so does torch's plain ``sum`` over a long axis (S_max = 2048 rows:
    2 of 4 batch rows differed from the row alone on the card), and a slot
    batch must decode each request exactly as a batch of one does
    (``infer/scheduler.py``). Each product writes and reads B·H·S_max·Dh f32
    elements, G times the cache rows it reads. q (B,1,H,Dh); ck, cv
    (B,S_max,Hkv,Dh); mask (B or 1,1,1,S_max).
    """
    b, _, h, dh = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, hkv, h // hkv, 1, dh).to(torch.float32)
    keys = ck.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S_max, Dh)
    logits = row_sum(qg * keys)[..., 0] / math.sqrt(dh)  # (B, Hkv, G, S_max)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype).to(torch.float32)
    vals = cv.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S_max, Dh)
    out = _rows_sum(probs[..., None] * vals)  # (B, Hkv, G, Dh)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _memory_decode(q: torch.Tensor, k_mem: torch.Tensor, v_mem: torch.Tensor) -> torch.Tensor:
    """Cross-attention of ``s`` query rows over a whole memory, one
    :func:`_sdpa_decode` call per row under an all-true mask (the function
    of :func:`_sdpa` with no mask): a row's bits then depend neither on
    the batch nor on the other rows of the call, so each token of a
    speculative verify gets the bits of a decode step. q (B, s, H, Dh);
    k_mem, v_mem (B, N, Hkv, Dh)."""
    mask = torch.ones((1, 1, 1, k_mem.shape[1]), dtype=torch.bool, device=q.device)
    return torch.cat([_sdpa_decode(q[:, i : i + 1], k_mem, v_mem, mask) for i in range(q.shape[1])], dim=1)


def _rows_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-2)`` of ``(..., S, D)`` in stages of
    :data:`~repro_torch.utils.ROW_SUM_WIDTH` rows (zero-padded): each stage
    sums 32 rows of D contiguous values for every output, which torch's CUDA
    reduction does in one order at any number of outputs (B 1..64 at
    llama3.2-3b's and recurrentgemma-9b's heads, S_max 536..3040, on the
    card; ``tests/test_torch_cuda.py::test_decode_attention_rows_equal_solo_on_card``),
    in 0.76-0.84x the time of :func:`~repro_torch.utils.row_sum` over a
    transposed copy (``tools/decode_attention_probe.py``)."""
    while x.shape[-2] > 1:
        pad = -x.shape[-2] % ROW_SUM_WIDTH
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        x = x.reshape(*x.shape[:-2], -1, ROW_SUM_WIDTH, x.shape[-1]).sum(-2)
    return x[..., 0, :]


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


def _local_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """Exact sliding-window causal attention in O(S·window) (the reference's
    training path): the sequence in window-sized chunks, each attending
    itself and the previous chunk under a banded causal mask. q, k, v
    (B, S, H or Hkv, Dh); a ragged S is padded at the end."""
    b, s, h, dh = q.shape
    w = window
    if s <= w:
        return _sdpa(q, k, v, causal_mask(s, s, w, device=q.device))
    if s % w:
        pad = w - s % w  # padded keys are "future" for every real query: masked
        padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v)]
        return _local_attention_chunked(*padded, window)[:, :s]
    nc, hkv = s // w, k.shape[2]
    g = h // hkv
    qc = q.reshape(b, nc, w, hkv, g, dh).to(torch.float32)
    kc = k.reshape(b, nc, w, hkv, dh)
    vc = v.reshape(b, nc, w, hkv, dh)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)  # zeros before chunk 0
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([kprev, kc], dim=2)  # (b, nc, 2w, hkv, dh)
    vv = torch.cat([vprev, vc], dim=2)
    qi = torch.arange(w, device=q.device)[:, None] + w  # a query's position in the 2w keys
    ki = torch.arange(2 * w, device=q.device)[None, :]
    mask = (ki <= qi) & (ki > qi - w)  # (w, 2w)
    first = torch.arange(nc, device=q.device) == 0
    # chunk 0 must not see the zero-padded "previous" keys
    mask_c = mask[None] & ~(first[:, None, None] & (ki < w)[None])  # (nc, w, 2w)
    logits = torch.einsum("bnqhgd,bnkhd->bnhgqk", qc, kk.to(torch.float32)) / math.sqrt(dh)
    logits = torch.where(mask_c[None, :, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", probs.to(vv.dtype).to(torch.float32), vv.to(torch.float32))
    return out.reshape(b, s, h, dh).to(q.dtype)


# Queries of one block of the local-attention prefill (:func:`_local_prefill`).
LOCAL_Q_BLOCK = 128


def _local_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, q_start: int = 0) -> torch.Tensor:
    """Sliding-window causal attention of the queries at positions
    ``q_start .. q_start + s - 1`` over the keys at positions ``0 ..
    q_start + s - 1``. q (B, s, H, Dh); k, v (B, q_start + s, Hkv, Dh).

    The queries run in blocks of :data:`LOCAL_Q_BLOCK` aligned to absolute
    positions (block j holds positions jC .. jC + C - 1, zero queries where
    the call has none), each against the W + C - 1 keys its band can reach
    (zero keys before position 0 or past the last, masked), as one
    :func:`_sdpa` call of the same shape for every block of every call. A
    row of such a product depends on its own query and keys only, so a
    prompt row gets the same bits in the whole prompt and in a suffix
    prefilled after a cached prefix (``q_start > 0``)."""
    b, s, h, dh = q.shape
    c, w = LOCAL_Q_BLOCK, window
    span = w + c - 1
    end = q_start + s
    first, last = q_start // c, -(-end // c)
    # keys: position p at index p + w - 1; zeros before 0 and up to the last block's end
    kpad = k.new_zeros((b, w - 1 + last * c, *k.shape[2:]))
    vpad = v.new_zeros((b, w - 1 + last * c, *v.shape[2:]))
    kpad[:, w - 1 : w - 1 + end] = k[:, :end]
    vpad[:, w - 1 : w - 1 + end] = v[:, :end]
    qpad = q.new_zeros((b, (last - first) * c, h, dh))
    qpad[:, q_start - first * c : q_start - first * c + s] = q
    r = torch.arange(c, device=q.device)[:, None]
    j = torch.arange(span, device=q.device)[None, :]
    band = (j >= r) & (j < r + w)  # key j of block-local query r: position jC - w + 1 + j
    outs = []
    for blk in range(first, last):
        kpos = blk * c - w + 1 + j
        mask = (band & (kpos >= 0))[None, None]
        lo = (blk - first) * c
        outs.append(_sdpa(qpad[:, lo : lo + c], kpad[:, blk * c : blk * c + span],
                          vpad[:, blk * c : blk * c + span], mask))
    out = torch.cat(outs, dim=1)
    return out[:, q_start - first * c : q_start - first * c + s]


def _ring_positions(slot: torch.Tensor, total, s_max: int) -> torch.Tensor:
    """The absolute position each ring slot holds after ``total`` writes
    (negative: never written)."""
    r = total % s_max
    base = total - r
    return torch.where(slot < r, base + slot, base - s_max + slot)


def _ring_mask(slot: torch.Tensor, pos, s_max: int, window: int) -> torch.Tensor:
    """Which ring slots a query at position ``pos`` (an int or a (B, 1)
    tensor) attends after its own write: written, at or before it, and
    inside its band."""
    stored = _ring_positions(slot, pos + 1, s_max)
    return (stored >= 0) & (stored <= pos) & (stored > pos - window)


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


def _cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor, pos: Pos, window: int = 0) -> dict:
    """Write ``s`` new K/V rows at absolute position ``pos`` (an int, a 0-d
    tensor, or a (B,) tensor of per-row positions), in place; an int8
    cache takes their codes and scales (:func:`_kv_quantize`).

    ``window > 0``: the cache is a ring of ``s_max`` rows and position p
    goes to slot ``p % s_max``; a write of ``s >= s_max`` rows (a prefill
    longer than the ring) keeps the last ``s_max``, rolled into their
    slots, as the reference does."""
    new = {"k": k, "v": v}
    if "k_scale" in cache:
        new["k"], new["k_scale"] = _kv_quantize(k)
        new["v"], new["v_scale"] = _kv_quantize(v)
    s, s_max = k.shape[1], cache["k"].shape[1]
    dev = cache["k"].device
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if window and s >= s_max:
            raise ValueError(f"per-row ring writes need s ({s}) < the ring's {s_max} rows")
        rows = torch.arange(cache["k"].shape[0], device=dev)[:, None]
        idx = pos.to(dev).long()[:, None] + torch.arange(s, device=dev)
        if window:
            idx = idx % s_max
        for name, val in new.items():
            cache[name][rows, idx] = val.to(cache[name].dtype)
        return cache
    p = host_pos(pos)
    if window and s >= s_max:
        base = (p + s - s_max) % s_max  # the slot of the first kept row
        for name, val in new.items():
            cache[name][:] = torch.roll(val[:, s - s_max :], base, dims=1).to(cache[name].dtype)
        return cache
    if window and (p % s_max) + s > s_max:
        idx = (p + torch.arange(s, device=dev)) % s_max
        for name, val in new.items():
            cache[name][:, idx] = val.to(cache[name].dtype)
        return cache
    if window:
        p %= s_max
    for name, val in new.items():
        cache[name][:, p : p + s] = val.to(cache[name].dtype)
    return cache


def gather_prefix_rows(cache: dict, start: int, n: int) -> dict:
    """A copy of rows ``[start, start + n)`` of every POSITIONAL leaf of a
    model cache (``(repeat, B, S_max, Hkv, Dh)`` → ``(repeat, B, n, Hkv,
    Dh)``; an int8 cache's scales ``(repeat, B, S_max, Hkv)`` alike), in
    the cache's tree without its recurrent leaves: a committed prefix
    block. A copy, never a view: a view would keep the whole cache alive and
    change with its next write. On a ring the caller keeps ``start + n``
    within the ring (the engine's ring guard), so rows sit at their
    positions."""
    return select_leaves(cache, POSITIONAL_CACHE_LEAVES, lambda leaf: leaf[:, :, start : start + n].clone())


def install_prefix_rows(cache: dict, rows: dict) -> dict:
    """Write gathered prefix rows (:func:`gather_prefix_rows`'s tree, ``L``
    rows a leaf; or a whole cache, whose recurrent leaves are skipped) into
    rows ``[0, L)`` of every positional leaf of ``cache``, in place;
    returns ``cache``."""

    def write(name, leaf, rw):
        if name in POSITIONAL_CACHE_LEAVES:
            leaf[:, :, : rw.shape[2]] = rw.to(leaf.dtype)

    walk_pairs(cache, rows, write)
    return cache


def snapshot_recurrent(cache: dict) -> dict:
    """A copy of the RECURRENT leaves of ``cache`` (its tree without the
    positional leaves): the boundary state a committed prefix block
    carries."""
    return select_leaves(cache, RECURRENT_CACHE_LEAVES, torch.clone)


def install_recurrent(cache: dict, snap: dict) -> dict:
    """Overwrite the recurrent leaves of ``cache`` in place from a snapshot
    (:func:`snapshot_recurrent`'s tree, or a whole cache whose positional
    leaves are skipped); returns ``cache``."""

    def write(name, leaf, sn):
        if name in RECURRENT_CACHE_LEAVES and sn is not leaf:
            leaf.copy_(sn)

    walk_pairs(cache, snap, write)
    return cache


def token_rows_view(x: torch.Tensor) -> torch.Tensor:
    """``(B, s, d)`` → ``(B·s, 1, d)``: each of a chunk's tokens as a row of
    its own (:func:`~repro_torch.utils.token_rows`), so the linears sum it
    exactly as they sum a decode step's row."""
    return x.reshape(-1, 1, x.shape[-1])


def _chunk_decode(q: torch.Tensor, cache: dict, pos: Pos, window: int = 0,
                  before: Optional[dict] = None) -> torch.Tensor:
    """Chunked decode (a speculative verify): query ``i`` of ``s`` attends
    the cache at position ``pos + i`` under its own mask, through one
    :func:`_sdpa_decode` call per chunk token, so each gets the bits of a
    single-token decode step at that position over the same cache. q
    (B, s, H, Dh) after the chunk's s K/V rows were written.

    On a ring (``window > 0``) a later token's write may have overwritten
    a row an earlier token attends: ``before`` holds the rows the chunk's
    writes replaced (``(B, s, ...)`` a leaf, token j's at slot ``(pos + j)
    % s_max``), and query ``i`` sees them back in their slots for every
    ``j > i``, the ring a decode step at ``pos + i`` reads, in slot order."""
    b, s = q.shape[:2]
    s_max = cache["k"].shape[1]
    slot = torch.arange(s_max, device=q.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        base = pos.to(q.device)[:, None]  # (B, 1)
    else:
        base = torch.full((b, 1), host_pos(pos), device=q.device)
    outs = []
    for i in range(s):
        view = cache
        if window and i < s - 1:
            view = {}
            rows = torch.arange(b, device=q.device)[:, None]
            idx = (base + torch.arange(i + 1, s, device=q.device)) % s_max  # (B, s - i - 1)
            for name, leaf in cache.items():
                restored = leaf.clone()
                restored[rows, idx] = before[name][:, i + 1 :]
                view[name] = restored
        ck, cv = _cache_kv(view, q.dtype)
        if window:
            mask = _ring_mask(slot[None, :], base + i, s_max, window)
        else:
            mask = slot[None, :] <= base + i
        outs.append(_sdpa_decode(q[:, i : i + 1], ck, cv, mask[:, None, None, :]))  # (B, 1, 1, S_max)
    return torch.cat(outs, dim=1)


def _gather_rows(cache: dict, pos: Pos, s: int) -> dict:
    """The rows at ring slots ``(pos + j) % s_max``, j < s, of every leaf of
    one layer's cache: ``(B, s, ...)`` copies."""
    leaf0 = cache["k"]
    b, s_max, dev = leaf0.shape[0], leaf0.shape[1], leaf0.device
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        base = pos.to(dev).long()[:, None]
    else:
        base = torch.full((b, 1), host_pos(pos), device=dev)
    idx = (base + torch.arange(s, device=dev)) % s_max
    rows = torch.arange(b, device=dev)[:, None]
    return {name: leaf[rows, idx] for name, leaf in cache.items()}


def attention(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    pos: Optional[Pos] = None,
    window: int = 0,
    chunked: bool = False,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self-attention; ``window > 0`` is local attention over a ring
    cache; ``kv_override=(k_mem, v_mem)`` is cross-attention over that
    memory (module docstring). Returns (out, cache).

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
    cross    kv_override=(k_mem, v_mem)  the queries attend the memory, no
                                         mask; ``cache`` (left as it is)
                                         only says that a single token
                                         without ``prompt_rows`` is a decode
                                         step; ``chunked`` as above
    """
    b, s, _ = x.shape
    xr = token_rows_view(x) if chunked else x
    if kv_override is not None:
        q = rope(linear(xr, p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head), positions, cfg.rope_theta)
        k_mem, v_mem = kv_override
        if chunked or (cache is not None and s == 1 and not in_prompt_rows()):
            out = _memory_decode(q, k_mem, v_mem)
        else:
            out = _sdpa(q, k_mem, v_mem, None)
        out = out.reshape(b, s, cfg.q_dim)
        return psum_partial(linear(token_rows_view(out) if chunked else out, p["wo"]).reshape(b, s, -1)), cache
    if "wqkv" in p:
        q, k, v = linear_fused(xr, p["wqkv"], (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    else:
        q, k, v = linear(xr, p["wq"]), linear(xr, p["wk"]), linear(xr, p["wv"])
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.d_head), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.d_head), positions, cfg.rope_theta)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)

    if chunked:
        before = _gather_rows(cache, pos, s) if window else None
        cache = _cache_write(cache, k, v, pos, window)
        out = _chunk_decode(q, cache, pos, window, before)
        y = linear(token_rows_view(out.reshape(b, s, cfg.q_dim)), p["wo"])
        return psum_partial(y.reshape(b, s, -1)), cache
    if cache is None:
        out = _local_attention_chunked(q, k, v, window) if window else _causal(q, k, v)
    elif s > 1 or in_prompt_rows():
        start = host_pos(pos)
        if window and start and start + s > cache["k"].shape[1]:
            raise ValueError(
                f"a prefill at pos {start} of {s} tokens passes the ring's {cache['k'].shape[1]} rows; "
                "a prompt that wraps the ring prefills whole from pos 0"
            )
        if start == 0:
            out = _local_prefill(q, k, v, window) if window else _causal(q, k, v)
            cache = _cache_write(cache, k, v, 0, window)
        else:
            cache = _cache_write(cache, k, v, start, window)
            ck, cv = _cache_kv(cache, q.dtype, start + s)
            out = _local_prefill(q, ck, cv, window, start) if window else _causal(q, ck, cv, q_start=start)
    else:
        cache = _cache_write(cache, k, v, pos, window)
        ck, cv = _cache_kv(cache, x.dtype)
        slot = torch.arange(ck.shape[1], device=x.device)
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            pb = pos.to(x.device)[:, None]  # (B, 1)
            valid = _ring_mask(slot[None, :], pb, ck.shape[1], window) if window else slot[None, :] <= pb
            mask = valid[:, None, None, :]
        else:
            pp = host_pos(pos)
            valid = _ring_mask(slot, pp, ck.shape[1], window) if window else slot <= pp
            mask = valid[None, None, None, :]
        out = _sdpa_decode(q, ck, cv, mask)
    return psum_partial(linear(out.reshape(b, s, cfg.q_dim), p["wo"])), cache


def mlp_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate_up" in p:
        w = p["w_gate_up"]
        d_ff = (w.o if isinstance(w, QuantizedTensor) else w.shape[-1]) // 2
        gate, up = linear_fused(x, w, (d_ff, d_ff))
    else:
        gate, up = linear(x, p["w_gate"]), linear(x, p["w_up"])
    return psum_partial(linear(torch.nn.functional.silu(gate) * up, p["w_down"]))
