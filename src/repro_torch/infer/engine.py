"""Batched generation engine (counterpart of ``repro/infer/engine.py``:
``Engine.__init__`` with fusion, ``Engine.generate`` and the slot-batched
serving API that ``infer/scheduler.py`` drives).

Weights live once, packed. Prefill runs the prompt through :func:`forward`
with a fresh KV cache; decode then feeds one sampled token per step. Every
quantized linear reaches its format's hand-written kernel through
``ops.qmatmul`` on the GPU.

The reference runs decode as one ``lax.scan`` (``scan=True``) or a host step
loop (``scan=False``). Here both are a Python step loop over the same
kernels: ``scan=True`` keeps the sampled tokens on the device and fetches
them once at the end, ``scan=False`` fetches each token as it is sampled.
They give bit-identical tokens. Capturing the loop as a CUDA graph is the
later counterpart of the scan.

Slot-batched serving (``init_slots`` / ``admit_slot`` / ``decode_slots`` /
``release_slot``): an ``n_slots``-row KV cache holds one request per row,
each with its own position, budget, temperature and ``torch.Generator``.
An admission is a whole-shot batch-1 prefill written straight into its
slot's cache rows; a decode chunk is a step loop over the whole batch in
which every row samples its own ``(1, V)`` logits row with its own
generator, so a slot emits exactly the tokens a solo
``generate(prompt, max_new_tokens, temperature=..., seed=...)`` emits.
That needs every row computed as a batch of one computes it: the kernels
reduce each row in a fixed order whatever the batch, the decode
attention sums each row's products on their own (``layers._sdpa_decode``)
and the dense products on the CPU run one batch row at a time
(``utils.matmul_rows``). Speculative slot
batches and chunked or prefix-cached admission are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import forward, fuse_decode_projections, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.utils import resolve_device, tree_map


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, prompt + generated)
    prompt_len: int
    steps: int
    # per-row index into the generated tokens of the first stop token
    # (-1 = none); set when generate(stop_tokens=...) was given
    stop_positions: Optional[np.ndarray] = None

    def generated(self, b: int = 0) -> np.ndarray:
        """Row ``b``'s generated tokens, cut after its first stop token
        (inclusive) when ``stop_tokens`` were given."""
        new = self.tokens[b, self.prompt_len :]
        if self.stop_positions is not None and self.stop_positions[b] >= 0:
            return new[: int(self.stop_positions[b]) + 1]
        return new


def stop_positions_for(new_tokens: np.ndarray, stop_tokens) -> np.ndarray:
    """(B, N) generated tokens → (B,) index of each row's first stop token
    (-1 if the row never emits one)."""
    hits = np.isin(np.asarray(new_tokens), np.asarray(list(stop_tokens), np.int64))
    first = np.argmax(hits, axis=1)
    return np.where(hits.any(axis=1), first, -1).astype(np.int32)


def _sample(
    logits: torch.Tensor, gen: Optional[torch.Generator], temperature: float, greedy: bool
) -> torch.Tensor:
    """(B, V) f32 logits → (B,) int64 tokens, on the logits' device.

    ``temperature <= 0`` falls back to argmax instead of dividing by zero.
    Sampling draws from ``gen`` (a seeded ``torch.Generator`` on the same
    device), so a fixed seed reproduces the stream; it is not the
    reference's threefry stream.
    """
    if greedy or temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_seq: int = 2048,
        fuse: bool = True,
        device="cuda",
    ):
        """``params`` are moved to ``device`` (default ``"cuda"``, which
        raises when no GPU is usable). ``fuse=False`` keeps the unfused
        per-projection layout."""
        self.cfg = cfg
        self.device = resolve_device(device)
        params = tree_map(lambda leaf: leaf.to(self.device), params)
        self.params = fuse_decode_projections(cfg, params) if fuse else params
        self.max_seq = max_seq

    def _make_cache(self, batch: int) -> dict:
        return init_cache(self.cfg, batch, self.max_seq, device=self.device)

    def _check_prompt(self, prompt: np.ndarray, n_new: int) -> None:
        s = prompt.shape[-1]
        if s + n_new > self.max_seq:
            raise ValueError(
                f"prompt_len({s}) + n_steps({n_new}) exceeds the engine's "
                f"cache length max_seq={self.max_seq} — build the Engine with a "
                f"larger max_seq or shorten the request"
            )
        if prompt.size and (prompt.min() < 0 or prompt.max() >= self.cfg.vocab):
            raise ValueError(
                f"prompt token ids must lie in [0, vocab={self.cfg.vocab}); got "
                f"range [{prompt.min()}, {prompt.max()}]"
            )

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict):
        """Prompt ``(B, S)`` → last-position logits ``(B, V)`` and the cache."""
        logits, cache = forward(
            self.cfg, self.params, tokens=tokens, cache=cache, pos=0, logits_mode="last"
        )
        return logits[:, -1], cache

    @torch.no_grad()
    def decode(self, tok: torch.Tensor, cache: dict, pos):
        """One step: tokens ``(B, 1)`` at position ``pos`` → logits ``(B, V)``."""
        logits, cache = forward(
            self.cfg, self.params, tokens=tok, cache=cache, pos=pos, logits_mode="last"
        )
        return logits[:, -1], cache

    @torch.no_grad()
    def generate(
        self,
        prompt_tokens: np.ndarray,
        n_steps: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        scan: bool = True,
        stop_tokens=None,
    ) -> GenerationResult:
        """Greedy (``temperature == 0``) or sampled autoregressive generation.

        ``stop_tokens`` (token ids) marks each row's first stop: decode still
        runs all ``n_steps``, the result records the stop positions and
        ``GenerationResult.generated(b)`` returns the cut completion, as the
        scheduler's early exit emits it."""
        b, s = prompt_tokens.shape[:2]
        pt = np.asarray(prompt_tokens)
        self._check_prompt(pt, n_steps)
        greedy = temperature <= 0
        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)

        cache = self._make_cache(b)
        tokens = torch.as_tensor(pt, dtype=torch.long, device=self.device)
        logits, cache = self.prefill(tokens, cache)
        steps = []
        for step in range(n_steps):
            tok = _sample(logits, gen, temperature, greedy)
            steps.append(tok if scan else tok.cpu().numpy())
            logits, cache = self.decode(tok[:, None], cache, s + step)
        if scan:
            new = torch.stack(steps, dim=1).cpu().numpy() if steps else np.zeros((b, 0))
        else:
            new = np.stack(steps, axis=1) if steps else np.zeros((b, 0))
        out = np.concatenate([pt, new.astype(pt.dtype)], axis=1)
        stops = stop_positions_for(new, stop_tokens) if stop_tokens else None
        return GenerationResult(tokens=out, prompt_len=s, steps=n_steps, stop_positions=stops)

    # -- slot-batched serving API (infer/scheduler.py drives these) ---------

    def init_slots(self, n_slots: int, speculate=None) -> dict:
        """Fresh slot-batched decode state: an ``n_slots``-row KV cache, the
        carried next-token logits ``(n_slots, V)`` and per-slot position,
        budget, sampling parameters and generator. All slots start inactive.

        The cache and the logits live on the engine's device; positions,
        the active mask, budgets and sampling parameters on the host
        (numpy), where each step decides how every row samples."""
        if speculate is not None:
            raise ValueError(
                "speculative slot batches need self-speculative decoding "
                "(infer/speculative.py), which is not ported yet"
            )
        if getattr(self.cfg, "input_kind", "tokens") != "tokens":
            raise ValueError(
                "slot-batched serving requires a tokens-input model "
                "(embedding inputs cannot be fed back by the slot loop)"
            )
        if getattr(self.cfg, "n_experts", 0):
            raise ValueError(
                "slot-batched serving does not support MoE models: shared "
                "expert capacity couples batch rows, breaking per-request "
                "token-identity (use one-shot Engine.generate instead)"
            )
        return {
            "cache": self._make_cache(n_slots),
            "logits": torch.zeros((n_slots, self.cfg.vocab), dtype=torch.float32, device=self.device),
            "pos": np.zeros((n_slots,), np.int64),
            "active": np.zeros((n_slots,), bool),
            "remaining": np.zeros((n_slots,), np.int64),
            "temperature": np.ones((n_slots,), np.float64),
            "greedy": np.ones((n_slots,), bool),
            "gens": [None] * n_slots,
        }

    def _slot_cache(self, slots: dict, slot: int) -> dict:
        """Views of one slot's rows of the slot cache (batch of one)."""
        return tree_map(lambda leaf: leaf[:, slot : slot + 1], slots["cache"])

    @torch.no_grad()
    def admit_slot(
        self,
        slots: dict,
        slot: int,
        prompt_tokens,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> dict:
        """Prefill one request (batch of one, the whole prompt at once) and
        install it into ``slot``: its KV rows, position, budget, sampling
        parameters and a generator seeded with ``seed``. The slot then emits
        the tokens a solo ``generate(prompt, max_new_tokens,
        temperature=..., seed=...)`` emits.

        The prefill writes its K/V rows straight into the slot's rows of the
        slot cache (no batch-1 cache and no copy); rows past the prompt keep
        the previous tenant's values, which are never read: decode writes row
        ``pos`` before it attends rows ``<= pos``."""
        prompt = np.asarray(prompt_tokens).reshape(1, -1)
        self._check_prompt(prompt, max_new_tokens)
        tokens = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
        logits1, _ = self.prefill(tokens, self._slot_cache(slots, slot))
        greedy = temperature <= 0
        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        slots["logits"][slot] = logits1[0]
        slots["pos"][slot] = prompt.shape[1]
        slots["active"][slot] = True
        slots["remaining"][slot] = max_new_tokens
        slots["temperature"][slot] = temperature if not greedy else 1.0
        slots["greedy"][slot] = greedy
        slots["gens"][slot] = gen
        return slots

    @torch.no_grad()
    def decode_slots(self, slots: dict, n_steps: int):
        """Run ``n_steps`` decode steps over the whole slot batch.

        Returns ``(tokens (B, n_steps) int32, active (B, n_steps) bool,
        slots)``; ``tokens[b, t]`` is a real emission iff ``active[b, t]``
        (else -1). Each active row samples its own ``(1, V)`` logits row
        with its own generator (greedy rows take the argmax), exactly as a
        solo ``generate`` of that request samples, and advances its
        position and budget; a row whose budget runs out goes inactive
        mid-chunk. Inactive rows still flow through the batched forward at a
        frozen position (clamped into the cache), decoding garbage into
        their own rows that admission later overwrites; their logits,
        positions and generators do not move.

        The slot state is committed at the end of the chunk: if a step
        raises, positions, budgets, logits and every generator are as they
        were before the call, so a retried chunk emits the same tokens."""
        gens = [g for g in slots["gens"] if g is not None]
        saved = [g.get_state() for g in gens]
        try:
            return self._decode_slots(slots, n_steps)
        except BaseException:
            for g, st in zip(gens, saved):
                g.set_state(st)
            raise

    def _decode_slots(self, slots: dict, n_steps: int):
        logits = slots["logits"]
        pos, active = slots["pos"].copy(), slots["active"].copy()
        remaining = slots["remaining"].copy()
        temps, greedy, gens = slots["temperature"], slots["greedy"], slots["gens"]
        cache, last = slots["cache"], self.max_seq - 1
        toks_steps, act_steps = [], []
        for _ in range(n_steps):
            act = active.copy()
            tok = torch.argmax(logits, dim=-1)
            for b in np.flatnonzero(act & ~greedy):
                probs = torch.softmax(logits[b : b + 1] / max(float(temps[b]), 1e-6), dim=-1)
                tok[b] = torch.multinomial(probs, 1, generator=gens[b])[0, 0]
            step_pos = torch.as_tensor(np.where(act, pos, np.minimum(pos, last)), device=self.device)
            new_logits, cache = self.decode(tok[:, None], cache, step_pos)
            act_dev = torch.as_tensor(act, device=self.device)
            logits = torch.where(act_dev[:, None], new_logits, logits)
            toks_steps.append(torch.where(act_dev, tok, -1))
            act_steps.append(act)
            pos = np.where(act, pos + 1, pos)
            remaining = np.where(act, remaining - 1, remaining)
            active = act & (remaining > 0)
        b = len(pos)
        toks = (torch.stack(toks_steps, dim=1).cpu().numpy().astype(np.int32) if toks_steps
                else np.zeros((b, 0), np.int32))
        acts = np.stack(act_steps, axis=1) if act_steps else np.zeros((b, 0), bool)
        slots.update(logits=logits, pos=pos, active=active, remaining=remaining)
        return toks, acts, slots

    def release_slot(self, slots: dict, slot: int) -> dict:
        """Reclaim one slot at a chunk boundary (cancel, timeout,
        quarantine): the row goes inactive with zero budget and stops
        emitting; the other rows are untouched, and the next admission
        overwrites the row's state."""
        slots["active"][slot] = False
        slots["remaining"][slot] = 0
        return slots

    def finite_logit_rows(self, slots: dict) -> np.ndarray:
        """(B,) host bools: row b's carried next-token logits are all finite
        (the scheduler's NaN/inf guard polls this at chunk boundaries)."""
        return torch.isfinite(slots["logits"]).all(dim=-1).cpu().numpy()

    def poison_logit_row(self, slots: dict, slot: int) -> dict:
        """Fault-injection hook (``infer/faults.py``): overwrite one row's
        carried logits with NaN, what an upstream numerical fault would leave
        behind. Host-side, between dispatches."""
        slots["logits"][slot] = float("nan")
        return slots
