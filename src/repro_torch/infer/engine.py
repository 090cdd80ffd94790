"""Batched generation engine (counterpart of ``repro/infer/engine.py``:
``Engine.__init__`` with fusion, and ``Engine.generate``).

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

    def generated(self, b: int = 0) -> np.ndarray:
        """Row ``b``'s generated tokens."""
        return self.tokens[b, self.prompt_len :]


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
    ) -> GenerationResult:
        """Greedy (``temperature == 0``) or sampled autoregressive generation."""
        cfg = self.cfg
        b, s = prompt_tokens.shape[:2]
        if s + n_steps > self.max_seq:
            raise ValueError(
                f"prompt_len({s}) + n_steps({n_steps}) exceeds the engine's "
                f"cache length max_seq={self.max_seq} — build the Engine with a "
                f"larger max_seq or shorten the request"
            )
        pt = np.asarray(prompt_tokens)
        if pt.size and (pt.min() < 0 or pt.max() >= cfg.vocab):
            raise ValueError(
                f"prompt token ids must lie in [0, vocab={cfg.vocab}); got "
                f"range [{pt.min()}, {pt.max()}]"
            )
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
        return GenerationResult(tokens=out, prompt_len=s, steps=n_steps)
