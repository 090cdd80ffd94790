"""Batched generation engine (counterpart of ``repro/infer/engine.py``:
``Engine.__init__`` with fusion, ``Engine.generate`` and the slot-batched
serving API that ``infer/scheduler.py`` drives).

Weights live once, packed. Prefill runs the prompt through :func:`forward`
with a fresh KV cache; decode then feeds one sampled token per step. Every
quantized linear reaches its format's hand-written kernel through
``ops.qmatmul`` on the GPU.

The reference runs decode as one ``lax.scan`` (``scan=True``) or a host step
loop (``scan=False``). Here ``scan=True`` replays one decode forward
captured as a CUDA graph (``infer/graphs.py``) every step, into a cache the
engine keeps for the last batch width it ran at and zeroes at the start of
each call, and
fetches the sampled tokens once at the end; ``scan=False`` runs each step's
forward eagerly, into a fresh cache, and fetches each token as it is
sampled. They give bit-identical tokens and logits. Sampling runs eagerly
between replays in both. On the CPU the graph's step runs eagerly on its
static buffers. ``decode_slots`` replays the graph of its slot width the
same way; the eager slot loop stays reachable through the private
``_EAGER_SLOT_STEPS`` switch below, for tests and the chip smoke, as the
oracle a replay is held to. Prefill, admissions, speculative chunks and
sampling stay eager.

Slot-batched serving (``init_slots`` / ``admit_slot`` / ``decode_slots`` /
``release_slot``): an ``n_slots``-row KV cache holds one request per row,
each with its own position, budget, temperature and ``torch.Generator``.
An admission is ``begin_admission`` → ``advance_admission`` →
``finish_admission`` (``admit_slot`` composes them): a whole-shot batch-1
prefill written straight into its slot's cache rows when nothing is cached
and nothing is chunked; otherwise (``infer/prefix_cache.py``) the longest
cached prefix of the prompt is installed into a batch-1 cache of the
admission's own, sized to the prompt, only the rest is prefilled there, in
chunks the scheduler interleaves with decode chunks (``chunked=True``), and
the prompt's rows are copied into the slot at finish. A pending admission
never writes its slot's rows: the decode loop writes every inactive row at
a frozen position. A warm or chunked admission gives the bits of the cold
whole-shot one on the GPU: every row of a prompt chunk is computed as in
the whole prompt (the kernels, ``utils.matmul_rows`` and the flash-attention
kernel's ``q_start``); on the CPU the same tokens, the plain attention
summing over another number of keys.

A decode chunk is a step loop over the whole batch in
which every row samples its own ``(1, V)`` logits row with its own
generator, so a slot emits exactly the tokens a solo
``generate(prompt, max_new_tokens, temperature=..., seed=...)`` emits.
That needs every row computed as a batch of one computes it: the kernels
reduce each row in a fixed order whatever the batch, the decode
attention sums each row's products on their own (``layers._sdpa_decode``)
and the dense products on the CPU run one batch row at a time
(``utils.matmul_rows``).

Self-speculative decoding (``generate(speculate=SpecConfig(...))``,
``init_slots(speculate=...)`` + ``spec_decode_slots``; ``infer/speculative.py``):
the ``q_draft``-plane truncation of the same weights (:meth:`Engine.draft_params`)
drafts γ tokens a chunk and one chunked forward of the full model verifies
them. Greedy output equals plain greedy output token for token, because the
verify gives each of its γ + 1 rows the bits of a decode step there. The
draft model's prefill is always whole-shot, into the slot's draft rows at
``finish_admission``: the draft cache has no prefix blocks to reuse.

Observability (``Engine(tracer=...)``, ``repro_torch.obs``): every
dispatch of the host (``engine/prefill``, ``engine/prefill_chunk``,
``engine/prefill_draft``, ``engine/prefix_install``, ``engine/admit``,
``engine/scan_decode``, ``engine/step_decode``, ``engine/spec_chunks``,
``engine/spec_generate``) runs in :meth:`Engine._obs_scope`: a tracer span
on the ``engine`` lane and a ``torch.profiler.record_function`` range of
the same name, so a profile says which host activity the device's kernels
belong to. A scope is entered only outside a graph capture (a
:class:`~repro_torch.infer.graphs.DecodeGraph`'s first calls warm up and
capture inside the scope of the call that makes them) and adds no device
sync: a span times the host call, including the sync its path already
makes when it reads tokens back.

Not ported: prefix caching and chunked prefill of ring-window and recurrent
models (the ring guard and the recurrent boundary snapshots); the
reference's power-of-two chunk buckets, which exist for XLA's compile
cache (chunks here are dispatched at their exact length).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import format_names, get_format
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.infer.graphs import DecodeGraph
from repro_torch.infer.prefix_cache import PrefixCache, PrefixHandle, check_observers, concat_rows, model_identity
from repro_torch.infer.speculative import (
    SpecConfig,
    draft_seed,
    freeze_inactive,
    has_recurrent_state,
    has_ring_buffer,
    spec_chunk,
)
from repro_torch.kernels import current_impl_mode
from repro_torch.models import forward, fuse_decode_projections, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gather_prefix_rows, install_prefix_rows
from repro_torch.quant import truncate_params
from repro_torch.utils import resolve_device, tree_leaves, tree_map

# True: decode_slots runs each step's forward eagerly instead of replaying a
# captured graph (the oracle that tests and the chip smoke hold replays to).
_EAGER_SLOT_STEPS = False


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, prompt + generated)
    prompt_len: int
    steps: int
    # per-row index into the generated tokens of the first stop token
    # (-1 = none); set when generate(stop_tokens=...) was given
    stop_positions: Optional[np.ndarray] = None
    # generate(speculate=...): accept_rate, accepted, proposed, chunks,
    # q_draft, gamma
    spec_stats: Optional[dict] = None

    def generated(self, b: int = 0) -> np.ndarray:
        """Row ``b``'s generated tokens, cut after its first stop token
        (inclusive) when ``stop_tokens`` were given."""
        new = self.tokens[b, self.prompt_len :]
        if self.stop_positions is not None and self.stop_positions[b] >= 0:
            return new[: int(self.stop_positions[b]) + 1]
        return new


@dataclasses.dataclass
class PendingAdmission:
    """One admission between :meth:`Engine.begin_admission` and
    :meth:`Engine.finish_admission`. A ``whole`` admission (no cached prefix,
    not chunked) has nothing to advance: its prefill runs at finish, straight
    into the slot's rows. Otherwise :meth:`Engine.advance_admission` prefills
    the prompt's uncached rows into ``cache1``, the admission's own batch-1
    cache sized to the prompt, from ``pos`` on (the matched prefix's rows
    installed before it)."""

    prompt: torch.Tensor  # (1, plen) int64, on the engine's device
    plen: int
    max_new_tokens: int
    temperature: float
    seed: int
    speculate: bool  # the request's opt-in (speculative slot batches)
    whole: bool  # one whole-shot prefill into the slot at finish
    handle: Optional[PrefixHandle] = None
    pos: int = 0  # prompt tokens whose K/V rows are in cache1
    cache1: Optional[dict] = None
    logits1: Optional[torch.Tensor] = None  # (1, V) at the last prompt position
    prefill_chunks: int = 0  # prefill dispatches (the lifecycle stamp)

    @property
    def done(self) -> bool:
        return self.whole or self.logits1 is not None


def stop_positions_for(new_tokens: np.ndarray, stop_tokens) -> np.ndarray:
    """(B, N) generated tokens → (B,) index of each row's first stop token
    (-1 if the row never emits one)."""
    hits = np.isin(np.asarray(new_tokens), np.asarray(list(stop_tokens), np.int64))
    first = np.argmax(hits, axis=1)
    return np.where(hits.any(axis=1), first, -1).astype(np.int32)


def _seeded(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


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
        prefix_cache: Optional[PrefixCache] = None,
        tracer=None,
    ):
        """``params`` are moved to ``device`` (default ``"cuda"``, which
        raises when no GPU is usable). ``fuse=False`` keeps the unfused
        per-projection layout.

        ``tracer`` (a :class:`repro_torch.obs.Tracer`) records a span around
        every engine dispatch on the ``engine`` lane (module docstring).

        ``prefix_cache`` (a :class:`~repro_torch.infer.prefix_cache.PrefixCache`)
        turns on prompt-prefix KV reuse for slot admissions: the longest
        committed prefix of a prompt is installed instead of recomputed, and
        the prompt's blocks are committed back at finish. The cache is bound
        to this engine's model identity."""
        check_observers(None, tracer, "Engine")
        self.cfg = cfg
        self.tracer = tracer
        self.device = resolve_device(device)
        params = tree_map(lambda leaf: leaf.to(self.device), params)
        self.params = fuse_decode_projections(cfg, params) if fuse else params
        self.max_seq = max_seq
        self._draft_params: dict = {}  # q_draft -> truncated params
        # generate(scan=True)'s cache and graphs, of one batch width (the last used)
        self._caches: dict = {}  # batch width -> the cache generate(scan=True) reuses
        self._graphs: dict = {}  # (batch width, impl mode) -> DecodeGraph over that cache
        self._graph_pool = None  # the CUDA graph memory pool this engine's captures share
        self.prefix_cache = prefix_cache
        self._last_prefix_handle: Optional[PrefixHandle] = None
        if prefix_cache is not None:
            why = self._prefix_refusal()
            if why:
                raise ValueError(f"prefix_cache: {why}")
            prefix_cache.bind(model_identity(cfg, self.params))

    def _make_cache(self, batch: int) -> dict:
        return init_cache(self.cfg, batch, self.max_seq, device=self.device)

    def _obs_scope(self, name: str, **args):
        """The scope of one host dispatch: a tracer span on the ``engine``
        lane (when a tracer is attached and enabled; a disabled or absent
        one reads no clock) and a ``torch.profiler.record_function`` range,
        which costs little without an active profiler. Never entered inside
        a graph capture; adds no device sync."""
        ctx = contextlib.ExitStack()
        if self.tracer is not None and self.tracer.enabled:
            ctx.enter_context(self.tracer.span(name, cat="engine", lane="engine", **args))
        ctx.enter_context(torch.profiler.record_function(name))
        return ctx

    # -- captured decode steps (infer/graphs.py) -----------------------------

    def _pool(self):
        """The handle of the memory pool this engine's next capture shares."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _new_graph(self, cache: dict, batch: int) -> DecodeGraph:
        # the graph reaches the engine's pool through a weak reference: a
        # bound method would make engine and graphs a reference cycle, which
        # only the cycle collector frees, at whatever moment it runs, and a
        # CUDA graph destroyed while another captures breaks that capture
        engine = weakref.ref(self)
        return DecodeGraph(self.cfg, self.params, cache, batch,
                           pool=(lambda: engine()._pool()) if self.device.type == "cuda" else None)

    def _generate_graph(self, batch: int) -> DecodeGraph:
        """The decode graph of ``generate(scan=True)`` at this width and the
        impl mode in force, over the engine's cache of that width, which is
        zeroed here: each call starts from a fresh cache's state. The engine
        keeps the cache and graphs of one width: a call at another width
        drops them first, so a caller that varies the width holds one
        ``max_seq`` cache and one width's graphs, not one per width. The
        dropped graphs' pool goes back to the device at the allocator's next
        ``empty_cache`` (each capture runs one), and later captures take a
        new pool: a pool whose graphs are all gone is not shared again."""
        if batch not in self._caches:
            self._caches.clear()
            self._graphs.clear()
            self._graph_pool = None
            self._caches[batch] = self._make_cache(batch)
        for leaf in tree_leaves(self._caches[batch]):
            leaf.zero_()
        key = (batch, current_impl_mode())
        if key not in self._graphs:
            self._graphs[key] = self._new_graph(self._caches[batch], batch)
        return self._graphs[key]

    def _slot_graph(self, slots: dict) -> DecodeGraph:
        """The decode graph of a slot batch under the impl mode in force,
        kept in the slot state beside the cache it writes (a new
        ``init_slots`` makes a new cache, and so a new capture)."""
        graphs = slots.setdefault("graphs", {})
        mode = current_impl_mode()
        if mode not in graphs or not graphs[mode].uses(slots["cache"]):
            graphs[mode] = self._new_graph(slots["cache"], len(slots["pos"]))
        return graphs[mode]

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

    # -- speculative decoding (infer/speculative.py) -------------------------

    def draft_params(self, q_draft: int):
        """The nested ``q_draft``-plane draft view of this engine's (fused)
        params: every quantized leaf truncated, everything else shared.
        Cached per ``q_draft``. A bcq leaf's draft is a view of its first
        planes; each layer's slice of it is contiguous, so the kernels'
        ``.contiguous()`` copies nothing at launch (checked here)."""
        if q_draft not in self._draft_params:
            draft = truncate_params(self.params, q_draft)
            for leaf in tree_leaves(draft):
                if isinstance(leaf, QuantizedTensor):
                    layer = (leaf.packed, leaf.scales) if leaf.packed.dim() == 3 else (leaf.packed[0], leaf.scales[0])
                    if not all(t.is_contiguous() for t in layer):
                        raise RuntimeError("a truncated leaf's per-layer slice is not contiguous")
            self._draft_params[q_draft] = draft
        return self._draft_params[q_draft]

    def _validate_spec(self, spec: SpecConfig) -> None:
        """Refuse what speculation cannot serve exactly: formats without a
        nested draft, non-token inputs, MoE, and the ring-window and
        recurrent families, whose rollback is not ported."""
        if not isinstance(spec, SpecConfig):
            raise ValueError(f"speculative decoding needs a SpecConfig, got {spec!r}")
        bad = sorted({
            leaf.fmt for leaf in tree_leaves(self.params)
            if isinstance(leaf, QuantizedTensor) and not get_format(leaf.fmt).supports_truncate
        })
        if bad:
            capable = [n for n in format_names() if get_format(n).supports_truncate]
            raise ValueError(
                f"speculative decoding needs truncation-capable weight formats; "
                f"{bad} do not support nested draft truncation "
                f"(truncation-capable formats: {capable})"
            )
        if getattr(self.cfg, "input_kind", "tokens") != "tokens":
            raise ValueError("speculative decoding requires a tokens-input model")
        if getattr(self.cfg, "n_experts", 0):
            raise ValueError(
                "speculative decoding does not support MoE models: shared expert "
                "capacity couples the verified chunk's tokens"
            )
        if has_ring_buffer(self.cfg) or has_recurrent_state(self.cfg):
            raise ValueError(
                "speculative decoding of ring-window or recurrent models needs the "
                "cache rollback (speculative.snapshot_rows / restore_rows / "
                "select_recurrent_*), not ported yet"
            )

    def _check_spec_headroom(self, plen: int, n_new: int, spec: SpecConfig) -> None:
        if plen + n_new + spec.gamma > self.max_seq:
            raise ValueError(
                f"prompt({plen}) + n_steps({n_new}) + gamma({spec.gamma}) exceeds "
                f"max_seq={self.max_seq}"
            )

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict):
        """Prompt ``(B, S)`` → last-position logits ``(B, V)`` and the cache."""
        logits, cache = forward(
            self.cfg, self.params, tokens=tokens, cache=cache, pos=0, logits_mode="last", prefill=True
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
        speculate: Optional[SpecConfig] = None,
        stop_tokens=None,
    ) -> GenerationResult:
        """Greedy (``temperature == 0``) or sampled autoregressive generation.

        ``speculate=SpecConfig(q_draft, gamma)`` decodes self-speculatively:
        greedy output equals plain greedy output token for token; sampled
        output follows the target's distribution by rejection sampling, from
        per-row generators (row ``b`` seeded ``seed + b``, its draft stream
        ``draft_seed(seed + b)``), so its stream is not the plain path's.
        ``GenerationResult.spec_stats`` reports the acceptance.

        ``stop_tokens`` (token ids) marks each row's first stop: decode still
        runs all ``n_steps``, the result records the stop positions and
        ``GenerationResult.generated(b)`` returns the cut completion, as the
        scheduler's early exit emits it."""
        b, s = prompt_tokens.shape[:2]
        pt = np.asarray(prompt_tokens)
        self._check_prompt(pt, n_steps)
        if speculate is not None:
            self._validate_spec(speculate)
            self._check_spec_headroom(s, n_steps, speculate)
            new, stats = self._spec_generate(pt, n_steps, temperature, seed, speculate)
            out = np.concatenate([pt, new.astype(pt.dtype)], axis=1)
            stops = stop_positions_for(new, stop_tokens) if stop_tokens else None
            return GenerationResult(tokens=out, prompt_len=s, steps=n_steps, stop_positions=stops,
                                    spec_stats=stats)
        greedy = temperature <= 0
        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)

        graph = self._generate_graph(b) if scan else None
        cache = graph.cache if scan else self._make_cache(b)
        tokens = torch.as_tensor(pt, dtype=torch.long, device=self.device)
        with self._obs_scope("engine/prefill", prompt_len=s, batch=b):
            logits, cache = self.prefill(tokens, cache)
        steps = []
        with self._obs_scope("engine/scan_decode" if scan else "engine/step_decode", n_steps=n_steps, batch=b):
            for step in range(n_steps):
                tok = _sample(logits, gen, temperature, greedy)
                steps.append(tok if scan else tok.cpu().numpy())
                if scan:
                    logits = graph(tok, s + step)
                else:
                    logits, cache = self.decode(tok[:, None], cache, s + step)
            if scan:
                new = torch.stack(steps, dim=1).cpu().numpy() if steps else np.zeros((b, 0))
            else:
                new = np.stack(steps, axis=1) if steps else np.zeros((b, 0))
        out = np.concatenate([pt, new.astype(pt.dtype)], axis=1)
        stops = stop_positions_for(new, stop_tokens) if stop_tokens else None
        return GenerationResult(tokens=out, prompt_len=s, steps=n_steps, stop_positions=stops)

    def _spec_generate(self, pt: np.ndarray, n_steps: int, temperature: float, seed: int,
                       spec: SpecConfig):
        """Both prefills whole-shot, the first token from the target's prefill
        logits, then chunks until every row has ``n_steps`` tokens →
        ((B, n_steps) tokens, spec_stats)."""
        b, s = pt.shape
        greedy = temperature <= 0
        draft = self.draft_params(spec.q_draft)
        tokens = torch.as_tensor(pt, dtype=torch.long, device=self.device)
        with self._obs_scope("engine/prefill", prompt_len=s, batch=b):
            logits, cache = self.prefill(tokens, self._make_cache(b))
        with self._obs_scope("engine/prefill_draft", prompt_len=s, batch=b, q_draft=spec.q_draft):
            _, dcache = forward(self.cfg, draft, tokens=tokens, cache=self._make_cache(b), pos=0,
                                logits_mode="last", prefill=True)
        gens = [None if greedy else _seeded(seed + i, self.device) for i in range(b)]
        dgens = [None if greedy else _seeded(draft_seed(seed + i), self.device) for i in range(b)]
        t0 = torch.argmax(logits, dim=-1)
        if not greedy:
            for i in range(b):
                t0[i] = torch.multinomial(
                    torch.softmax(logits[i : i + 1] / max(temperature, 1e-6), dim=-1), 1, generator=gens[i]
                )[0, 0]
        rows = [[t] for t in t0.cpu().numpy().tolist()]
        state = {"t_pend": t0, "pos": np.full((b,), s, np.int64), "cache": cache, "draft_cache": dcache,
                 "logits": logits}
        emitted = np.ones((b,), np.int64)
        acc = prop = chunks = 0
        flags = dict(greedy=np.full((b,), greedy), temperature=np.full((b,), temperature if not greedy else 1.0),
                     spec_enabled=np.ones((b,), bool))
        with self._obs_scope("engine/spec_generate", n_steps=n_steps, gamma=spec.gamma):
            while n_steps and (emitted < n_steps).any():
                active = emitted < n_steps
                commit, n_keep, new_state = spec_chunk(
                    self.cfg, self.params, draft, state, gamma=spec.gamma, active=active,
                    gens=gens, draft_gens=dgens, **flags,
                )
                for i in np.flatnonzero(active):
                    rows[i].extend(commit[i, : n_keep[i]].tolist())
                # acceptances past the n_steps cut are not counted
                acc += int(np.minimum(n_keep - 1, n_steps - emitted)[active].sum())
                prop += int(active.sum()) * spec.gamma
                chunks += 1
                emitted = np.where(active, emitted + n_keep, emitted)
                state = freeze_inactive(new_state, state, active)
        new = np.asarray([r[:n_steps] for r in rows], np.int64).reshape(b, n_steps)
        stats = {"accept_rate": acc / max(prop, 1), "accepted": acc, "proposed": prop, "chunks": chunks,
                 "q_draft": spec.q_draft, "gamma": spec.gamma}
        return new, stats

    # -- slot-batched serving API (infer/scheduler.py drives these) ---------

    def _prefix_refusal(self) -> Optional[str]:
        """Why this model cannot take a prefix cache or chunked prefill, or
        None: the slot-serving gate, and the pieces of the ring-window and
        recurrent families that are not ported."""
        if getattr(self.cfg, "input_kind", "tokens") != "tokens" or getattr(self.cfg, "n_experts", 0):
            return "needs a tokens-input, non-MoE model (the slot-batched serving gate)"
        if has_ring_buffer(self.cfg):
            return ("ring-window models need the ring guard (a prompt past the window "
                    "bypasses the cache), not ported yet")
        if has_recurrent_state(self.cfg):
            return ("recurrent models need the recurrent boundary snapshots "
                    "(layers.snapshot_recurrent / install_recurrent), not ported yet")
        return None

    def init_slots(self, n_slots: int, speculate: Optional[SpecConfig] = None) -> dict:
        """Fresh slot-batched decode state: an ``n_slots``-row KV cache, the
        carried next-token logits ``(n_slots, V)`` and per-slot position,
        budget, sampling parameters and generator. All slots start inactive.

        The cache and the logits live on the engine's device; positions,
        the active mask, budgets and sampling parameters on the host
        (numpy), where each step decides how every row samples.

        ``speculate`` makes the batch speculative: the state keeps the
        SpecConfig and grows a draft cache, each row's pending token
        ``t_pend``, a per-row opt-in ``spec`` and draft generators; drive it with
        :meth:`spec_decode_slots` instead of :meth:`decode_slots`."""
        if speculate is not None:
            self._validate_spec(speculate)
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
        slots = {
            "cache": self._make_cache(n_slots),
            "logits": torch.zeros((n_slots, self.cfg.vocab), dtype=torch.float32, device=self.device),
            "pos": np.zeros((n_slots,), np.int64),
            "active": np.zeros((n_slots,), bool),
            "remaining": np.zeros((n_slots,), np.int64),
            "temperature": np.ones((n_slots,), np.float64),
            "greedy": np.ones((n_slots,), bool),
            "gens": [None] * n_slots,
        }
        if speculate is not None:
            slots.update(
                speculate=speculate,
                draft_cache=self._make_cache(n_slots),
                t_pend=torch.zeros((n_slots,), dtype=torch.long, device=self.device),
                spec=np.zeros((n_slots,), bool),
                draft_gens=[None] * n_slots,
            )
        return slots

    def _slot_cache(self, slots: dict, slot: int, key: str = "cache") -> dict:
        """Views of one slot's rows of the slot cache ``key`` (batch of one)."""
        return tree_map(lambda leaf: leaf[:, slot : slot + 1], slots[key])

    @property
    def supports_chunked_prefill(self) -> bool:
        """True when chunked prefill (and a prefix cache) can serve this
        model: the dense decoder; not the ring-window or recurrent families,
        whose pieces are not ported (:meth:`_prefix_refusal`)."""
        return self._prefix_refusal() is None

    @torch.no_grad()
    def begin_admission(
        self,
        prompt_tokens,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        speculate: bool = True,
        chunked: bool = False,
    ) -> PendingAdmission:
        """Start one slot admission: validate, consult the prefix cache and
        install any matched prefix into the admission's own batch-1 cache.
        Drive the result with :meth:`advance_admission` and install it with
        :meth:`finish_admission` (or release it with :meth:`abort_admission`
        on any failure or cancel in between). ``chunked=True`` lets the
        scheduler advance it by a token budget a step."""
        prompt = np.asarray(prompt_tokens).reshape(1, -1)
        self._check_prompt(prompt, max_new_tokens)
        if chunked and not self.supports_chunked_prefill:
            raise ValueError(f"chunked prefill: {self._prefix_refusal()}")
        plen = prompt.shape[1]
        p = PendingAdmission(
            prompt=torch.as_tensor(prompt, dtype=torch.long, device=self.device), plen=plen,
            max_new_tokens=max_new_tokens, temperature=temperature, seed=seed, speculate=speculate,
            whole=not chunked,
        )
        if self.prefix_cache is None:
            return p
        # at least the last prompt token prefills: decode needs its logits
        p.handle = self.prefix_cache.begin(prompt[0], max_match=plen - 1, max_commit=plen)
        try:
            if p.handle.length:
                p.whole = False
                with self._obs_scope("engine/prefix_install", hit_tokens=p.handle.length):
                    p.cache1 = init_cache(self.cfg, 1, plen, device=self.device)
                    install_prefix_rows(p.cache1, concat_rows([nd.rows for nd in p.handle.matched]))
                p.pos = p.handle.length
        except BaseException:
            self.prefix_cache.abort(p.handle)
            raise
        return p

    @torch.no_grad()
    def advance_admission(self, pending: PendingAdmission, budget: Optional[int] = None) -> int:
        """Prefill up to ``budget`` more prompt tokens (None: the rest) into
        the admission's batch-1 cache, one forward of exactly that many
        tokens at its position → the tokens consumed. A ``whole`` admission
        consumes nothing here (its prefill runs at finish)."""
        p = pending
        if p.done:
            return 0
        n = p.plen - p.pos if budget is None else min(p.plen - p.pos, budget)
        if n <= 0:
            return 0
        with self._obs_scope("engine/prefill_chunk", pos=p.pos, n_tokens=n):
            if p.cache1 is None:
                p.cache1 = init_cache(self.cfg, 1, p.plen, device=self.device)
            logits, _ = forward(self.cfg, self.params, tokens=p.prompt[:, p.pos : p.pos + n], cache=p.cache1,
                                pos=p.pos, logits_mode="last", prefill=True)
        p.pos += n
        p.prefill_chunks += 1
        if p.pos == p.plen:
            p.logits1 = logits[:, -1]
        return n

    @torch.no_grad()
    def finish_admission(self, slots: dict, slot: int, pending: PendingAdmission) -> dict:
        """Install a finished admission into ``slot`` and commit the prompt's
        new prefix blocks (copies of its rows) to the prefix cache.

        A ``whole`` admission prefills here, straight into the slot's rows
        (no batch-1 cache and no copy); rows past the prompt keep the
        previous tenant's values, which are never read: decode writes row
        ``pos`` before it attends rows ``<= pos``. Any other admission's rows
        ``[0, plen)`` are copied from its batch-1 cache into the slot.

        In a speculative batch (``init_slots(speculate=...)``) the draft
        model prefills the whole prompt into the slot's draft-cache rows,
        and the request's first token is sampled here as a plain decode's
        first step samples it, left in ``slots["t_pend"][slot]`` and counted
        against the budget (the caller emits it; a budget of one completes
        here). A sampled row's draft generator is seeded ``draft_seed(seed)``.
        ``speculate=False`` opts the request out: it commits one plain token
        a chunk, the stream of a solo plain ``generate``."""
        p = pending
        if not p.done:
            raise ValueError("admission is not finished: drive advance_admission until pending.done")
        spec = slots.get("speculate")
        if spec is not None:
            self._check_spec_headroom(p.plen, p.max_new_tokens, spec)
        rows = self._slot_cache(slots, slot)
        if p.whole:
            with self._obs_scope("engine/prefill", prompt_len=p.plen):
                p.logits1, _ = self.prefill(p.prompt, rows)
            p.prefill_chunks = 1
        if spec is not None:
            with self._obs_scope("engine/prefill_draft", prompt_len=p.plen, q_draft=spec.q_draft):
                forward(self.cfg, self.draft_params(spec.q_draft), tokens=p.prompt,
                        cache=self._slot_cache(slots, slot, "draft_cache"), pos=0, logits_mode="last",
                        prefill=True)
        with self._obs_scope("engine/admit", slot=slot, **({} if spec is None else {"spec": True})):
            return self._install_admission(slots, slot, p, rows, spec)

    def _install_admission(self, slots: dict, slot: int, p: PendingAdmission, rows: dict, spec) -> dict:
        """The install half of :meth:`finish_admission`: the prompt's rows
        into the slot (a whole admission prefilled them there), the prefix
        blocks to commit, the slot's sampling state and, in a speculative
        batch, its first token."""
        if p.whole:
            src = rows
        else:
            install_prefix_rows(rows, p.cache1)
            src = p.cache1
        h = p.handle
        if h is not None and not h.closed and not h.rows:
            h.rows = [gather_prefix_rows(src, s, e - s) for s, e in h.new_spans]
            h.snaps = [None] * len(h.rows)
        greedy = p.temperature <= 0
        gen = None if greedy else _seeded(p.seed, self.device)
        slots["logits"][slot] = p.logits1[0]
        slots["pos"][slot] = p.plen
        slots["active"][slot] = True
        slots["remaining"][slot] = p.max_new_tokens
        slots["temperature"][slot] = p.temperature if not greedy else 1.0
        slots["greedy"][slot] = greedy
        slots["gens"][slot] = gen
        if spec is not None:
            t0 = torch.argmax(p.logits1[0])
            if not greedy:
                t0 = torch.multinomial(
                    torch.softmax(p.logits1[0:1] / max(float(p.temperature), 1e-6), dim=-1), 1, generator=gen
                )[0, 0]
            slots["t_pend"][slot] = t0
            slots["spec"][slot] = bool(p.speculate)
            slots["draft_gens"][slot] = None if greedy else _seeded(draft_seed(p.seed), self.device)
            slots["remaining"][slot] = p.max_new_tokens - 1
            slots["active"][slot] = p.max_new_tokens > 1
        if h is not None:
            self.prefix_cache.complete(h)
        self._last_prefix_handle = h
        return slots

    def abort_admission(self, pending: Optional[PendingAdmission]) -> None:
        """Release an admission that will never finish (cancel, deadline, a
        failed prefill): unpin its prefix handle without committing. Safe
        with None and when called again."""
        if pending is not None and pending.handle is not None:
            self.prefix_cache.abort(pending.handle)

    def take_prefix_handle(self) -> Optional[PrefixHandle]:
        """Pop the (closed) prefix handle of the latest finished admission;
        the scheduler reads the hit length off it for the lifecycle stamp."""
        h, self._last_prefix_handle = self._last_prefix_handle, None
        return h

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
        speculate: bool = True,
    ) -> dict:
        """Prefill one request (batch of one) and install it into ``slot``:
        its KV rows, position, budget, sampling parameters and a generator
        seeded with ``seed``. The slot then emits the tokens a solo
        ``generate(prompt, max_new_tokens, temperature=..., seed=...)``
        emits. The synchronous composition of :meth:`begin_admission`,
        :meth:`advance_admission` and :meth:`finish_admission` (see there for
        the prefix cache and speculative batches); a failure on the way
        releases the prefix handle."""
        pending = self.begin_admission(prompt_tokens, max_new_tokens=max_new_tokens, temperature=temperature,
                                       seed=seed, speculate=speculate)
        try:
            self.advance_admission(pending)
            return self.finish_admission(slots, slot, pending)
        except BaseException:
            self.abort_admission(pending)
            raise

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
            with self._obs_scope("engine/scan_decode", n_steps=n_steps):
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
        graph = None if _EAGER_SLOT_STEPS else self._slot_graph(slots)
        toks_steps, act_steps = [], []
        for _ in range(n_steps):
            act = active.copy()
            tok = torch.argmax(logits, dim=-1)
            for b in np.flatnonzero(act & ~greedy):
                probs = torch.softmax(logits[b : b + 1] / max(float(temps[b]), 1e-6), dim=-1)
                tok[b] = torch.multinomial(probs, 1, generator=gens[b])[0, 0]
            step_pos = torch.as_tensor(np.where(act, pos, np.minimum(pos, last)), device=self.device)
            if graph is None:
                new_logits, cache = self.decode(tok[:, None], cache, step_pos)
            else:
                new_logits = graph(tok, step_pos)
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

    @torch.no_grad()
    def spec_decode_slots(self, slots: dict, n_chunks: int):
        """Run ``n_chunks`` speculative chunks over the whole slot batch.

        Returns ``(tokens (B, n_chunks·(γ+1)) int32, valid (B, same) bool,
        slots)``; each chunk gives an active row 1..γ + 1 valid tokens (one
        for a row admitted with ``speculate=False``), clipped to its budget.
        Inactive rows flow through every forward at a frozen position,
        clamped so the chunk's γ + 1 writes stay inside the cache.

        As :meth:`decode_slots`, the slot state is committed at the end: if a
        chunk raises, positions, budgets, pending tokens and every generator
        are as they were before the call."""
        spec = slots.get("speculate")
        if spec is None:
            raise ValueError("slots were not initialised with speculate=...")
        gens = [g for g in slots["gens"] + slots["draft_gens"] if g is not None]
        saved = [g.get_state() for g in gens]
        try:
            with self._obs_scope("engine/spec_chunks", n_chunks=n_chunks, gamma=spec.gamma):
                return self._spec_decode_slots(slots, n_chunks, spec)
        except BaseException:
            for g, st in zip(gens, saved):
                g.set_state(st)
            raise

    def _spec_decode_slots(self, slots: dict, n_chunks: int, spec: SpecConfig):
        draft = self.draft_params(spec.q_draft)
        state = {key: slots[key] for key in ("t_pend", "cache", "draft_cache", "logits")}
        state["pos"] = slots["pos"].copy()
        active, remaining = slots["active"].copy(), slots["remaining"].copy()
        width = spec.gamma + 1
        toks, valid = [], []
        for _ in range(n_chunks):
            commit, n_keep, new_state = spec_chunk(
                self.cfg, self.params, draft, state, gamma=spec.gamma, greedy=slots["greedy"],
                temperature=slots["temperature"], spec_enabled=slots["spec"], active=active,
                gens=slots["gens"], draft_gens=slots["draft_gens"],
            )
            emit_n = np.where(active, np.minimum(n_keep, remaining), 0)
            ok = np.arange(width)[None, :] < emit_n[:, None]
            toks.append(np.where(ok, commit, -1))
            valid.append(ok)
            remaining = remaining - emit_n
            state = freeze_inactive(new_state, state, active)
            active = active & (remaining > 0)
        b = len(active)
        out_toks = np.concatenate(toks, axis=1).astype(np.int32) if toks else np.zeros((b, 0), np.int32)
        out_valid = np.concatenate(valid, axis=1) if valid else np.zeros((b, 0), bool)
        slots.update(t_pend=state["t_pend"], pos=state["pos"], logits=state["logits"],
                     cache=state["cache"], draft_cache=state["draft_cache"],
                     active=active, remaining=remaining)
        return out_toks, out_valid, slots

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
