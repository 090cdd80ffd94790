"""Self-speculative decoding from nested BCQ precisions (counterpart of
``repro/infer/speculative.py``).

BCQ is nested by construction: the first ``q'`` sign planes of a ``q``-bit
weight (``packed[:q']``, ``scales[:q']``) are themselves a valid ``q'``-bit
weight, since the greedy solver builds plane ``i`` from the residual of the
planes before it (paper §III.A). Every quantized model therefore carries a
cheaper draft model, :func:`repro_torch.quant.truncate_params`, whose
matmuls read ``q'/q`` of the planes. One chunk:

- **draft**: γ + 1 single-token decode steps of the truncated model propose
  ``d_1..d_γ`` (the last step only writes ``d_γ``'s K/V rows);
- **verify**: one chunked forward of the full model over
  ``[t_pend, d_1..d_γ]`` (``forward(chunked_decode=True)``), whose logits
  at every position are those of a single-token decode step there, bit for
  bit;
- **accept**: prefix match for greedy rows, rejection sampling (Leviathan
  et al., 2023) for sampled rows; the accepted prefix plus one correction
  or bonus token is committed, so every chunk emits 1..γ + 1 tokens and
  greedy output equals plain greedy output token for token.

The port's caches are linear, so a rejected suffix needs no row restore:
the rewound position masks those rows, and they are written again before
anything reads them. Ring windows and recurrent state need the reference's
``snapshot_rows`` / ``restore_rows`` / ``select_recurrent_*``, which come
with those model families; the engine refuses such a config until then.

Sampling draws from per-row ``torch.Generator``s, as the slot API does. A
row's commit generator is the one its plain decode would use: a row that does
not speculate (``spec_enabled`` False) draws its token with exactly the call
``Engine._decode_slots`` makes, so its stream is the plain one bit for bit.
Proposals and acceptance uniforms come from a second per-row generator,
seeded ``draft_seed(seed)``; per chunk a sampled speculating row draws γ
proposals from it, then γ uniforms. Inactive rows draw nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig

# The draft generator of a request seeded ``s`` is seeded ``s ^ DRAFT_SEED_XOR``
# (the reference's draft-key rule, ``PRNGKey(seed ^ 0x5BEC)``).
DRAFT_SEED_XOR = 0x5BEC


def draft_seed(seed: int) -> int:
    """Seed of the draft generator (proposals, acceptance uniforms) of a
    request or row seeded ``seed``."""
    return int(seed) ^ DRAFT_SEED_XOR


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs: draft precision (BCQ planes) and draft length.

    ``q_draft`` planes of the target's own quantized weights form the draft
    (dense leaves are shared, so a dense model drafts with itself and accepts
    every proposal). ``gamma`` tokens are proposed per chunk; each chunk
    commits between 1 and ``gamma + 1`` tokens.
    """

    q_draft: int = 2
    gamma: int = 4

    def __post_init__(self):
        if self.q_draft < 1:
            raise ValueError(f"q_draft must be >= 1, got {self.q_draft}")
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")

    @classmethod
    def parse(cls, text: str) -> "SpecConfig":
        """Parse the CLI form ``q_draft:gamma`` (e.g. ``2:4``); every failure
        raises a ``ValueError`` naming the expected ``QD:GAMMA`` syntax."""
        syntax = (
            "expected 'QD:GAMMA' — two ':'-separated integers, QD = draft "
            "bit-planes >= 1, GAMMA = proposals per chunk >= 1 (e.g. '2:4')"
        )
        try:
            q_draft, gamma = (int(t) for t in text.split(":"))
        except ValueError as e:
            raise ValueError(f"{syntax}; got {text!r}") from e
        try:
            return cls(q_draft=q_draft, gamma=gamma)
        except ValueError as e:
            raise ValueError(f"{syntax}; got {text!r} ({e})") from e


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """True if any block carries non-positional (recurrent) decode state."""
    return any(bt in ("rglru", "mlstm", "slstm") for pattern, _ in cfg.stages for bt in pattern)


def has_ring_buffer(cfg: ModelConfig) -> bool:
    """True if any block's KV cache is a ring buffer (local attention)."""
    return any(bt == "local_attn" for pattern, _ in cfg.stages for bt in pattern)


def freeze_inactive(new_state: dict, old_state: dict, active: np.ndarray) -> dict:
    """Inactive rows keep their pre-chunk pending token, position and carried
    logits. Caches are not frozen: an inactive row's writes land at or past
    its frozen position and are never attended (admission rewrites the row).
    Its generators did not move: :func:`spec_chunk` draws only for active
    rows."""
    act = torch.as_tensor(active, device=new_state["t_pend"].device)
    return dict(
        new_state,
        t_pend=torch.where(act, new_state["t_pend"], old_state["t_pend"]),
        pos=np.where(active, new_state["pos"], old_state["pos"]),
        logits=torch.where(act[:, None], new_state["logits"], old_state["logits"]),
    )


def _draw(logits_row: torch.Tensor, temperature: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """One token from a ``(1, V)`` f32 logits row, as ``Engine._decode_slots``
    samples a slot row: softmax at the temperature, one multinomial draw."""
    probs = torch.softmax(logits_row / max(float(temperature), 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[0, 0]


@torch.no_grad()
def spec_chunk(
    cfg: ModelConfig,
    params,
    draft_params,
    state: dict,
    *,
    gamma: int,
    greedy: np.ndarray,  # (B,) bool
    temperature: np.ndarray,  # (B,) float (ignored where greedy)
    spec_enabled: np.ndarray,  # (B,) bool: False rows commit one plain token a chunk
    active: np.ndarray,  # (B,) bool: rows that draw from their generators
    gens: Sequence[Optional[torch.Generator]],
    draft_gens: Sequence[Optional[torch.Generator]],
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """One speculative chunk over the whole batch.

    ``state``: ``{"t_pend" (B,) int64 tensor, "pos" (B,) int64 numpy,
    "cache", "draft_cache", "logits" (B, V)}``; caches are written in
    place. An inactive row runs at a position clamped so its γ + 1 writes
    stay inside the cache.

    Returns ``(commit (B, γ+1), n_keep (B,), new_state)`` (numpy int64):
    row ``b`` committed ``commit[b, :n_keep[b]]``, the accepted proposals and
    one correction or bonus token; ``new_state`` has that token pending, the
    position advanced by ``n_keep`` and ``"logits"``, the verify's logits at
    the commit position (those of the pending token's step). Callers apply
    :func:`freeze_inactive`.
    """
    t_pend, pos = state["t_pend"], state["pos"]
    cache, dcache = state["cache"], state["draft_cache"]
    dev = t_pend.device
    b = t_pend.shape[0]
    n_tok = gamma + 1
    last = cache["stages"][0]["b0"]["k"].shape[2] - n_tok  # the last start whose writes fit
    run_pos = torch.as_tensor(np.where(active, pos, np.minimum(pos, last)), device=dev)
    sampled = np.flatnonzero(active & ~greedy)
    spec_sampled = [i for i in sampled if spec_enabled[i]]

    # -- draft: gamma + 1 single-token steps of the truncated model
    tok, props, q_logits = t_pend, [], []
    for j in range(n_tok):
        lg, dcache = forward(
            cfg, draft_params, tokens=tok[:, None], cache=dcache, pos=run_pos + j, logits_mode="last"
        )
        if j == gamma:  # this step only writes d_gamma's K/V rows
            break
        lg = lg[:, -1]
        q_logits.append(lg)
        tok = torch.argmax(lg, dim=-1)
        for i in spec_sampled:
            tok[i] = _draw(lg[i : i + 1], temperature[i], draft_gens[i])
        props.append(tok)
    drafts = torch.stack(props, dim=1)  # (B, gamma): d_1..d_gamma
    q_logits = torch.stack(q_logits, dim=1)  # (B, gamma, V); [:, i] proposed d_{i+1}

    # -- verify: one chunked forward of the target over [t_pend, d_1..d_gamma]
    verify = torch.cat([t_pend[:, None], drafts], dim=1)
    p_logits, cache = forward(
        cfg, params, tokens=verify, cache=cache, pos=run_pos, logits_mode="all", chunked_decode=True
    )  # (B, gamma + 1, V); [:, i] = the target's step logits at pos + i

    # -- accept: prefix match (greedy rows) / rejection sampling (sampled rows)
    accepted = drafts == torch.argmax(p_logits[:, :gamma], dim=-1)
    for i in spec_sampled:
        t = max(float(temperature[i]), 1e-6)
        d = drafts[i][:, None]
        p = torch.softmax(p_logits[i, :gamma] / t, dim=-1).gather(-1, d)[:, 0]
        q = torch.softmax(q_logits[i] / t, dim=-1).gather(-1, d)[:, 0]
        u = torch.rand((gamma,), generator=draft_gens[i], device=dev)
        accepted[i] = u < p / q.clamp_min(1e-30)
    accepted &= torch.as_tensor(spec_enabled, device=dev)[:, None]
    n_acc_dev = torch.cumprod(accepted.to(torch.int64), dim=1).sum(dim=1)
    n_acc = n_acc_dev.cpu().numpy()  # the chunk's one host sync

    # -- commit token: the correction at the first rejection, or the bonus
    rows = torch.arange(b, device=dev)
    p_at = p_logits[rows, n_acc_dev]  # (B, V)
    t_next = torch.argmax(p_at, dim=-1)
    for i in sampled:
        n = int(n_acc[i])
        row = p_logits[i : i + 1, n]
        if not spec_enabled[i]:
            t_next[i] = _draw(row, temperature[i], gens[i])  # the plain slot stream
            continue
        t = max(float(temperature[i]), 1e-6)
        resid = torch.softmax(row / t, dim=-1)
        if n < gamma:  # max(p - q, 0) at a rejection; p itself for the bonus
            resid = (resid - torch.softmax(q_logits[i : i + 1, n] / t, dim=-1)).clamp_min(0.0)
        resid = torch.where(resid.sum() > 0, resid, torch.softmax(row / t, dim=-1))
        t_next[i] = torch.multinomial(resid, 1, generator=gens[i])[0, 0]

    commit = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    commit[rows, n_acc_dev] = t_next
    n_keep = n_acc + 1
    new_state = dict(
        state,
        t_pend=t_next,
        pos=pos + n_keep,
        cache=cache,
        draft_cache=dcache,
        logits=p_at,
    )
    return commit.cpu().numpy(), n_keep, new_state
