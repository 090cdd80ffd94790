"""Mixture-of-experts FFN with sort-and-bucket capacity dispatch
(counterpart of ``repro/models/moe.py``: ``init_moe``, ``_capacity``,
``_moe_apply_global`` and ``load_balance_loss``).

Top-k routing (OLMoE: 64 experts, top-8; Llama-4-Maverick: 128, top-1 and a
shared expert). A token's assignments are sorted by expert id, each expert
takes a buffer of ``capacity`` rows, the banks' grouped SwiGLU runs over
every expert's buffer (``kernels.ops.expert_linear``: one grouped
hand-written kernel launch for gate and up together and one for down on
the GPU, K12, which skips each expert's empty rows), and the outputs are
combined back, weighted by the renormalised router probabilities.
Assignments past an expert's capacity are dropped, as the reference drops
them.

Where the reference leaves an order to XLA, this port fixes it:

- top-k: ``lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` leaves that order open, so the port takes
  the first k of a stable descending sort.
- the sort by expert is stable (``torch.sort(stable=True)``), as the
  reference's ``argsort(stable=True)``.
- per-expert counts are a ``scatter_add_`` of ones, exact in integers:
  ``torch.bincount`` on CUDA reads its maximum back to the host, which a
  captured decode step (``infer/graphs.py``) cannot do.
- the combine gathers each token's k weighted contributions and adds them in
  x's dtype in ascending expert order, the order in which the reference's
  serial scatter-add applies them (its list is sorted by expert). CUDA's
  ``index_add_`` of floats is atomic and its order free, so a rerun would
  not give the same bits.
- casts: expert buffers in x's dtype; gate and up in f32; ``silu(gate)·up``
  cast to x's dtype before ``w_down``; the output buffer cast to x's dtype;
  the routing weight ``sp·keep`` cast to x's dtype before the product; the
  shared expert added after the combine.

The reference computes the load-balance loss always and leaves XLA to drop
it where unused; here :func:`moe_apply` computes it only when asked
(``aux=True``: a training forward, ``models.forward(with_aux=True)``), so a
captured decode step carries no dead work. The reference's sharded
expert-parallel path (``_moe_apply_sharded``) runs only under an ambient
mesh, which its training entry point never sets: it has no counterpart yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import expert_linear, expert_linear_pair, linear
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead=(), device="cuda") -> dict:
    """``router`` f32 ``(*lead, d, E)``, ``w_gate`` / ``w_up`` ``(*lead, E,
    d, F)``, ``w_down`` ``(*lead, E, F, d)``, and ``shared`` (an MLP) where
    the config has a shared expert: the reference's leaves, shapes, dtypes
    and scales (its banks are a ``(d, E·F)`` init reshaped and transposed,
    so each expert's matrix is ``(d, F)`` scaled by 1/sqrt(d))."""
    e, d, f, pd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.pdtype
    p = {
        "router": L._dense_init(gen, (*lead, d, e), d, torch.float32, device),
        "w_gate": L._dense_init(gen, (*lead, e, d, f), d, pd, device),
        "w_up": L._dense_init(gen, (*lead, e, d, f), d, pd, device),
        "w_down": L._dense_init(gen, (*lead, e, f, d), f, pd, device),
    }
    if cfg.shared_expert:
        p["shared"] = L.init_mlp(gen, cfg, lead, device)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows of each expert's buffer: ``capacity_factor · T · k / E``, cut to
    an int, rounded up to a multiple of 8, at least 8 (the reference's
    ``_capacity``)."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits ``(T, E)`` f32 → (``top_p`` (T, k) renormalised, ``top_e``
    (T, k) int64): the softmax, then the first k of a stable descending
    sort, so equal probabilities take the lower expert index first, as
    ``lax.top_k`` does."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[:, :k], idx[:, :k]
    return top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9), top_e


def dispatch(top_e: torch.Tensor, n_experts: int, cap: int):
    """Sort-and-bucket: ``top_e (T, k)`` → (``order`` (T·k,) the stable sort
    of the flat assignments by expert, ``se`` their experts, ``st`` their
    tokens, ``keep`` (within capacity), ``slot`` (their row in the expert's
    buffer; ``cap`` for a dropped one), ``rows`` the filled rows of each
    expert's buffer, ``min(count, cap)``, ``(E,)`` int32 on the device (no
    read-back: the kernels skip the rest))."""
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")  # the reference's repeat(arange(t), k)[order]
    counts = torch.zeros(n_experts, dtype=torch.int64, device=top_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))  # not bincount: no read-back to the host
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=top_e.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))
    return order, se, st, keep, slot, torch.clamp_max(counts, cap).to(torch.int32)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *, aux: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x (B, S, D)`` → (``(B, S, D)``, the load-balance loss if ``aux``
    else None). Capacity couples a call's tokens: every token of the call
    competes for the same expert rows."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)

    logits = linear(xf, p["router"], out_dtype=torch.float32)  # (T, E)
    top_p, top_e = route(logits, k)
    order, se, st, keep, slot, rows = dispatch(top_e, e, cap)
    sp = top_p.reshape(-1)[order]

    # per-expert buffers (E, C + 1, D): dropped assignments land in a
    # sacrificial last row, cut off before the products
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[se, slot] = xf[st]
    buf = buf[:, :cap].contiguous()

    gate, up = expert_linear_pair(buf, p["w_gate"], p["w_up"], rows=rows)
    h = (torch.nn.functional.silu(gate) * up).to(x.dtype)
    out_buf = expert_linear(h, p["w_down"], rows=rows).to(x.dtype)  # (E, C, D); rows past `rows` are zero

    contrib = out_buf[se, torch.clamp_max(slot, cap - 1)] * (sp * keep).to(x.dtype)[:, None]
    # each token's k contributions, in ascending position of the sorted list
    # (= ascending expert id), added in x's dtype one at a time
    pos = torch.empty_like(order)
    pos[order] = torch.arange(t * k, device=x.device)
    mine = contrib[torch.sort(pos.reshape(t, k), dim=-1).values]  # (T, k, D)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + mine[:, j]

    if cfg.shared_expert:
        out = out + L.mlp_swiglu(p["shared"], x).reshape(t, d)
    loss = load_balance_loss(logits, top_e, e) if aux else None
    return out.reshape(b, s, d), loss


def load_balance_loss(router_logits: torch.Tensor, top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: ``E · Σ_e mean_prob_e · top1_fraction_e``."""
    probs = torch.softmax(router_logits, dim=-1)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(top_e[:, 0], n_experts).to(torch.float32).mean(0)
    return n_experts * torch.sum(me * ce)
