"""Captured decode steps: the port's counterpart of the reference's jitted
decode scans, ``_scan_decode`` and ``_scan_decode_slots``
(``repro/infer/engine.py``).

The reference runs N decode steps as one ``lax.scan`` dispatch. Here one
decode forward, tokens ``(B, 1)`` at positions ``(B,)`` into a persistent
KV cache → logits ``(B, V)``, is captured once as a ``torch.cuda.CUDAGraph``
and replayed every step: about 2000 kernel launches a forward become one
graph launch. Sampling stays eager between replays, on the replayed logits,
from each row's own ``torch.Generator`` (``infer/engine.py``), so every
token stream is the eager loop's.

A :class:`DecodeGraph` belongs to one (batch width, cache, params, impl
mode); the cache fixes the cache dtype. What a capture would freeze, and
how this module keeps it true:

- **Positions** come only from the static ``(B,)`` device tensor, so the
  step takes the per-row paths of ``models/layers.py``; a scalar position
  raises under capture (``utils.host_pos``).
- **The cache** is the caller's, at fixed addresses: the engine keeps the
  one of the last width ``generate`` ran at and zeroes it in place
  (``Engine.generate``), and a slot batch's cache is written in place by
  admissions.
- **The split-k workspace** is the graph's own
  (``kernels/_common.py::Workspace``): the first call runs the real step
  eagerly on the capture stream, which sizes it at the graph's shapes, and
  it is frozen before capture, so it can never grow under the graph.
- **Process-global modes**: the graph remembers ``ops.impl_mode`` and
  refuses to replay under another.
- **Launch counts**: the wrappers count in Python, which a replay does not
  run; the capture's counts are taken back and added once a replay
  (``kernels.add_counters``).

There is no fallback: a failed capture or replay raises. On the CPU a
:class:`DecodeGraph` runs its step eagerly on the same static buffers,
because the caller asked for the CPU.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from repro_torch.kernels import add_counters, counters, current_impl_mode, set_counters
from repro_torch.kernels._common import Workspace, use_workspace
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.utils import tree_leaves

_STREAMS: dict = {}  # device → the side stream that warms up and captures


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def counted(fn):
    """Run ``fn()`` and take back what it added to the kernel counters →
    (its result, the counts it added). A capture counts the launches it
    records, none of which runs; each replay then adds them
    (:func:`~repro_torch.kernels.add_counters`)."""
    before = counters()
    try:
        out = fn()
        delta = tuple(a - b for a, b in zip(counters(), before))
    finally:
        set_counters(before)
    return out, delta


class DecodeGraph:
    """One decode forward at batch width ``B`` over ``cache``, captured on
    its second call and replayed from then on (module docstring). Call it
    with tokens ``(B,)`` or ``(B, 1)`` and positions (an int, or ``(B,)``)
    → logits ``(B, V)`` f32. On the card the returned logits are the
    graph's output buffer: read them before the next replay of any graph
    that shares its memory pool. ``pool``: a function that returns the
    handle of the memory pool to capture into, called at capture."""

    def __init__(self, cfg: ModelConfig, params, cache: dict, batch: int, *, pool: Optional[Callable] = None):
        dev = tree_leaves(cache)[0].device
        self.cfg, self.params, self.cache, self.batch = cfg, params, cache, batch
        self.mode = current_impl_mode()
        self.tokens = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.pool = pool
        self.workspace = Workspace()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None  # the graph's output buffer
        self.warmed = False
        self.delta: tuple = ()  # the counts a replay adds
        self.replays = 0

    def step(self) -> torch.Tensor:
        """The captured function: one forward on the static buffers."""
        logits, _ = forward(self.cfg, self.params, tokens=self.tokens, cache=self.cache, pos=self.pos,
                            logits_mode="last")
        return logits[:, -1]

    def uses(self, cache: dict) -> bool:
        """Whether this graph's step reads and writes ``cache``'s tensors."""
        return all(a is b for a, b in zip(tree_leaves(self.cache), tree_leaves(cache)))

    def __call__(self, tok: torch.Tensor, pos) -> torch.Tensor:
        if current_impl_mode() != self.mode:
            raise RuntimeError(
                f"a decode graph captured under impl_mode({self.mode!r}) cannot replay under "
                f"impl_mode({current_impl_mode()!r})"
            )
        self.tokens.copy_(tok.reshape(self.batch, 1))
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(pos)
        if not self.tokens.is_cuda:
            return self.step()
        if not self.warmed:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_counters(self.delta)
        self.replays += 1
        return self.logits

    def _warm_up(self) -> torch.Tensor:
        """The first call: the real step, eagerly on the capture stream, in
        the graph's workspace (library handles, kernel modules and the
        workspace's size at these shapes come from here, not from capture)."""
        stream = _capture_stream(self.tokens.device)
        main = torch.cuda.current_stream(self.tokens.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream), use_workspace(self.workspace):
            out = self.step()
        main.wait_stream(stream)
        out.record_stream(main)
        self.warmed = True
        return out

    def _capture(self) -> None:
        """Capture the step into the memory pool ``pool()`` names (a private
        one without ``pool``), taken now: the engine's pool may have changed
        since this graph was made. Dead reference cycles are collected first
        (``torch.cuda.graph`` no longer does): one that holds a CUDA graph,
        freed by a collection during this capture, would destroy that graph
        mid-capture, and in the global capture mode that ends the capture."""
        gc.collect()
        self.workspace.freeze()
        graph = torch.cuda.CUDAGraph()
        pool = self.pool() if self.pool is not None else None

        def capture():
            with torch.cuda.graph(graph, pool=pool, stream=_capture_stream(self.tokens.device)), \
                    use_workspace(self.workspace):
                return self.step()

        self.logits, self.delta = counted(capture)
        self.graph = graph
