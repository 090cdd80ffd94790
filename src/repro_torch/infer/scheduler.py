"""Continuous-batching scheduler over the slot-batched decode path
(counterpart of ``repro/infer/scheduler.py``, with its contract).

The paper's workload (§V) is many concurrent decode requests against one
weight-resident quantized model. One-shot ``Engine.generate`` runs a fixed
batch in lockstep; this module keeps a fixed-width decode batch full
instead (Orca-style continuous batching):

- requests wait in a **bounded admission queue**;
- the decode batch has ``n_slots`` **slots**; a free slot is filled by a
  batch-1 prefill of the next queued request, installed into the slot
  (``Engine.admit_slot``); on the GPU that prefill's attention runs on the
  flash-attention kernel at the request's own prompt length;
- decode runs in **chunks** of ``chunk`` steps over the whole batch
  (``Engine.decode_slots``); per-slot active masks let requests finish
  mid-chunk without stalling neighbours;
- a finished slot is freed and refilled at the next chunk boundary.

Correctness contract (``tests/test_torch_scheduler.py``): the interleaving
is *invisible* — each request's tokens are identical to running it alone
through ``Engine.generate(prompt, max_new_tokens, temperature=..., seed=...)``,
because batch rows are independent in the forward (per-slot positions,
cache rows and generators, and per-row products: see ``infer/engine.py``).

**Request lifecycle** (``infer/lifecycle.py``): QUEUED → PREFILLING →
DECODING → {FINISHED, CANCELLED, TIMED_OUT, FAILED}, with SHED for
deadline-aware queue shedding and a loud :class:`QueueFullError` when the
bounded queue rejects a submit. Whatever happens to any subset of requests —
cancellation, deadline expiry, injected dispatch failures, NaN-poisoned
rows — every surviving request's tokens stay bit-identical to an
undisturbed run (``tests/test_torch_lifecycle.py``). The mechanisms:

- **cancellation** (:meth:`Scheduler.cancel` only flags): the slot is
  reclaimed at the next chunk boundary (``Engine.release_slot``);
- **deadlines**: per-request TTFT and total deadlines, checked at chunk
  boundaries against the injectable ``clock``; queued requests whose
  deadline already passed are SHED before they cost a prefill;
- **NaN/inf logit guard**: a per-chunk (B,)-bool check; a non-finite row is
  FAILED and its slot scrubbed while neighbours decode on untouched;
- **bounded retry with backoff** around every engine dispatch; a prefill
  that keeps failing fails only its request, a decode chunk that keeps
  failing fails the active tenants and rebuilds the slot state so queued
  requests still complete;
- **fault injection** (``infer/faults.py``): a :class:`FaultPlan` threaded
  through the dispatch points makes all of the above testable.

**Stop tokens**: ``Request.stop_tokens`` finish a row early — host-side
truncation at the chunk boundary (the stop token is kept), the slot frees at
once, and the completion equals a solo ``generate`` cut at the same place.

**Speculative slots** (``speculate=SpecConfig(...)``, ``infer/speculative.py``):
each dispatch runs ``chunk`` speculative chunks (``Engine.spec_decode_slots``),
each committing 1..γ + 1 tokens a row; admission emits the request's first
token, so a budget-1 request completes at admission, and every request needs
γ + 1 cache rows of headroom. ``Request.speculate=False`` opts a request out:
it commits one plain token a chunk, its solo plain ``generate``'s stream.
Greedy and opted-out requests stay identical to their solo plain ``generate``.

Not ported: chunked prefill (``prefill_chunk``, needs chunked admission),
the prefix cache, and the span tracer and metrics registry (``tracer``,
``metrics``, from ``repro.obs``). Each of those arguments raises when set,
naming what is missing.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.infer.engine import Engine
from repro_torch.infer.faults import FaultPlan
from repro_torch.infer.lifecycle import (
    QueueFullError,
    RequestLifecycle,
    RequestState,
    latency_summary,
)
from repro_torch.infer.speculative import SpecConfig


class DispatchError(RuntimeError):
    """An engine dispatch kept failing after bounded retries."""


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` and ``temperature`` are per request:
    greedy and sampled requests share a batch. In a speculative scheduler,
    ``speculate=False`` opts the request out of drafting (None or True: it
    speculates); elsewhere it is ignored.

    ``stop_tokens`` ends the generation early at the first matching token
    (kept; the slot frees at the next chunk boundary).
    ``ttft_deadline_s`` / ``deadline_s`` are wall-clock budgets from submit:
    a request that misses one is TIMED_OUT (or SHED while still queued) at
    the next chunk boundary."""

    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    speculate: Optional[bool] = None
    stop_tokens: Optional[Sequence[int]] = None
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    rid: Optional[int] = None  # assigned at submit() if None

    def __post_init__(self):
        arr = np.asarray(self.prompt)
        if arr.dtype.kind not in "iu":
            # a silent float -> int cast would truncate values the caller
            # never meant as token ids
            raise ValueError(f"prompt must be integer token ids, got dtype {arr.dtype}")
        self.prompt = arr.astype(np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # NaN/inf would poison sampling silently, a negative temperature
        # would invert the distribution; exactly 0.0 means greedy
        if not np.isfinite(self.temperature):
            raise ValueError(f"temperature must be finite, got {self.temperature!r}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), got {self.temperature!r}")
        self.temperature = float(self.temperature)
        # the seed goes to torch.Generator.manual_seed; keep the reference's
        # int64 range so a request valid there is valid here
        if isinstance(self.seed, bool) or not isinstance(self.seed, (int, np.integer)):
            raise ValueError(f"seed must be an integer, got {self.seed!r}")
        if not (-(2**63) <= int(self.seed) < 2**63):
            raise ValueError(f"seed must fit in int64 ([-2**63, 2**63)), got {self.seed}")
        self.seed = int(self.seed)
        if self.stop_tokens is not None:
            if any(
                isinstance(t, bool) or not isinstance(t, (int, np.integer))
                for t in self.stop_tokens
            ):
                raise ValueError(f"stop_tokens must be integer token ids, got {self.stop_tokens!r}")
            self.stop_tokens = tuple(int(t) for t in self.stop_tokens)
        for name in ("ttft_deadline_s", "deadline_s"):
            v = getattr(self, name)
            if v is not None and not (np.isfinite(v) and v > 0):
                raise ValueError(f"{name} must be a positive number, got {v!r}")


@dataclasses.dataclass
class Completion:
    rid: int
    prompt: np.ndarray  # (prompt_len,)
    new_tokens: np.ndarray  # (<= max_new_tokens,) — shorter iff stopped early
    admitted_at_step: int  # scheduler decode-step counter at admission
    finished_at_step: int
    stopped: bool = False  # True iff ended on a stop token before the budget

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generation, the layout ``GenerationResult.tokens`` uses."""
        return np.concatenate([self.prompt, self.new_tokens])


class _Tenant:
    __slots__ = ("req", "emitted", "admitted_at_step", "stop")

    def __init__(self, req: Request, admitted_at_step: int):
        self.req = req
        self.emitted: List[int] = []
        self.admitted_at_step = admitted_at_step
        self.stop = frozenset(req.stop_tokens or ())


class Scheduler:
    """Continuous-batching front end for one :class:`Engine`.

    >>> sched = Scheduler(engine, n_slots=4)
    >>> sched.submit(Request(prompt, max_new_tokens=16))
    >>> done = sched.run()   # or: sched.step() in a serving loop

    - ``speculate``: a :class:`SpecConfig` makes every dispatch ``chunk``
      speculative chunks (module docstring), with γ + 1 rows of headroom.
    - ``max_queue`` bounds the admission queue; a full queue rejects at
      ``submit`` with :class:`QueueFullError` (None = unbounded).
    - ``retries`` / ``backoff_s``: bounded exponential-backoff retry around
      every engine dispatch.
    - ``nan_guard``: per-chunk non-finite-logit check; poisoned rows are
      FAILED and their slot scrubbed, neighbours untouched.
    - ``faults``: a :class:`FaultPlan` threaded through the dispatch points.
    - ``clock`` / ``sleep``: injectable time sources for deadlines and
      backoff (tests drive them with ``faults.StepClock``).
    - ``on_tokens(rid, tokens)``: fired at every chunk boundary with the
      request's newly visible (post-truncation) tokens.
    - ``on_event(record)``: fired at every terminal transition with the
      request's :class:`RequestLifecycle` (partial tokens attached).

    Single-threaded: drive ``submit`` / ``step`` / ``run`` from one thread.
    :meth:`cancel` only flags; the flag applies at the next chunk boundary.
    """

    def __init__(
        self,
        engine: Engine,
        n_slots: int = 4,
        chunk: int = 8,
        speculate: Optional[SpecConfig] = None,
        *,
        prefill_chunk: Optional[int] = None,
        max_queue: Optional[int] = 64,
        retries: int = 2,
        backoff_s: float = 0.05,
        nan_guard: bool = True,
        faults: Optional[FaultPlan] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        on_tokens: Optional[Callable[[int, List[int]], None]] = None,
        on_event: Optional[Callable[[RequestLifecycle], None]] = None,
        tracer=None,
        metrics=None,
    ):
        for given, what in (
            (prefill_chunk, "prefill_chunk needs chunked admission (Engine.begin_admission / "
                            "advance_admission), not ported yet"),
            (tracer, "tracer needs the span tracer (repro.obs), not ported yet"),
            (metrics, "metrics needs the metrics registry (repro.obs), not ported yet"),
        ):
            if given is not None:
                raise ValueError(what)
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.engine = engine
        self.n_slots = n_slots
        self.chunk = chunk
        self.speculate = speculate
        self.max_queue = max_queue
        self.retries = retries
        self.backoff_s = backoff_s
        self.nan_guard = nan_guard
        self.faults = faults
        self.on_tokens = on_tokens
        self.on_event = on_event
        self._clock = clock
        self._sleep = sleep
        self.slots = engine.init_slots(n_slots, speculate=speculate)
        self.queue: Deque[Request] = deque()
        self._tenants: List[Optional[_Tenant]] = [None] * n_slots
        self.outcomes: Dict[int, RequestLifecycle] = {}
        self._pending_cancel: Dict[int, str] = {}
        self.decode_steps = 0  # total chunked decode steps executed
        self.steps_active = 0  # sum over steps of active slots (utilisation); tokens in spec mode
        self.chunk_rows = 0  # spec mode: row-chunks dispatched (the accept-rate estimate)
        self.counters: Dict[str, int] = {
            "rejected_queue_full": 0,
            "shed": 0,
            "cancelled": 0,
            "timed_out": 0,
            "failed": 0,
            "nan_quarantined": 0,
            "retries": 0,
            "decode_dispatch_failures": 0,
            "stopped_early": 0,
        }
        self._chunk_ordinal = 0  # decode dispatches over the lifetime
        self._rid_counter = itertools.count()
        self._used_rids = set()  # rids ever seen by this scheduler

    # -- queue ---------------------------------------------------------------

    def submit(self, req: Request) -> int:
        plen = int(req.prompt.size)
        headroom = 0 if self.speculate is None else self.speculate.gamma + 1
        if plen + req.max_new_tokens + headroom > self.engine.max_seq:
            raise ValueError(
                f"request needs {plen + req.max_new_tokens + headroom} cache rows "
                f"(incl. {headroom} speculation headroom), engine "
                f"max_seq={self.engine.max_seq}"
            )
        vocab = self.engine.cfg.vocab
        if req.prompt.min() < 0 or req.prompt.max() >= vocab:
            raise ValueError(
                f"prompt token ids must lie in [0, vocab={vocab}); got range "
                f"[{req.prompt.min()}, {req.prompt.max()}] — out-of-range ids "
                f"index garbage embedding rows"
            )
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # a loud reject with its reason: the caller decides whether to
            # retry, and the queue never grows without bound
            self.counters["rejected_queue_full"] += 1
            raise QueueFullError(
                f"admission queue full ({self.max_queue} waiting): request "
                f"rejected — resubmit later, shrink the burst, or raise max_queue"
            )
        if req.rid is None:
            # skip values a caller-supplied rid already claimed
            req.rid = next(r for r in self._rid_counter if r not in self._used_rids)
        elif req.rid in self._used_rids:
            raise ValueError(
                f"rid {req.rid!r} already used in this scheduler (a Request "
                "submitted elsewhere keeps its assigned rid — pass a fresh "
                "Request or an explicit unique rid)"
            )
        self._used_rids.add(req.rid)
        self.outcomes[req.rid] = RequestLifecycle(rid=req.rid, submitted_at=self._clock())
        self.queue.append(req)
        return req.rid

    def cancel(self, rid: int, reason: str = "cancelled by client") -> bool:
        """Flag a request for cancellation; applied at the next chunk
        boundary (queued → removed before prefill, decoding → slot
        reclaimed). False if the rid is unknown or already terminal."""
        rec = self.outcomes.get(rid)
        if rec is None or rec.state.terminal:
            return False
        self._pending_cancel[rid] = reason
        return True

    @property
    def n_active(self) -> int:
        return sum(t is not None for t in self._tenants)

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_active == 0

    @property
    def spec_accept_rate(self) -> float:
        """Estimated draft acceptance over all speculative dispatches: a
        row-chunk commits 1 + γ·accept_rate tokens on average (a slight
        underestimate when rows finish mid-dispatch). 0.0 until a speculative
        chunk has run."""
        if self.speculate is None or self.chunk_rows == 0:
            return 0.0
        tokens_per_row_chunk = self.steps_active / self.chunk_rows
        return max(0.0, (tokens_per_row_chunk - 1.0) / self.speculate.gamma)

    def summary(self) -> dict:
        """Lifecycle and latency summary: TTFT/TPOT percentiles over finished
        requests, terminal-state counts and the robustness counters."""
        out = latency_summary(self.outcomes.values())
        out["counters"] = dict(self.counters)
        out["decode_steps"] = self.decode_steps
        return out

    # -- lifecycle internals -------------------------------------------------

    def _terminal(
        self,
        rec: RequestLifecycle,
        state: RequestState,
        reason: str,
        tokens: Optional[List[int]] = None,
    ) -> None:
        rec.transition(state, self._clock(), reason)
        rec.new_tokens = np.asarray(tokens or [], np.int32)
        rec.n_tokens = int(rec.new_tokens.size)
        if self.on_event is not None:
            self.on_event(rec)

    def _evict(self, slot: int, state: RequestState, reason: str) -> None:
        """Reclaim a slot mid-flight (cancel, timeout, quarantine): terminal
        transition with the partial tokens, then deactivate the row."""
        tenant = self._tenants[slot]
        assert tenant is not None
        self._terminal(self.outcomes[tenant.req.rid], state, reason, tokens=tenant.emitted)
        self._tenants[slot] = None
        self.slots = self.engine.release_slot(self.slots, slot)

    def _apply_cancels(self) -> None:
        if not self._pending_cancel:
            return
        keep: Deque[Request] = deque()
        for req in self.queue:
            reason = self._pending_cancel.pop(req.rid, None)
            if reason is None:
                keep.append(req)
            else:
                self.counters["cancelled"] += 1
                self._terminal(self.outcomes[req.rid], RequestState.CANCELLED, reason)
        self.queue = keep
        for slot, tenant in enumerate(self._tenants):
            if tenant is None:
                continue
            reason = self._pending_cancel.pop(tenant.req.rid, None)
            if reason is not None:
                self.counters["cancelled"] += 1
                self._evict(slot, RequestState.CANCELLED, reason)
        self._pending_cancel.clear()  # unknown or raced rids: nothing to do

    def _enforce_deadlines(self) -> None:
        now = self._clock()
        # queued requests whose deadline already passed are shed before
        # they cost a prefill
        keep: Deque[Request] = deque()
        for req in self.queue:
            rec = self.outcomes[req.rid]
            waited = now - rec.submitted_at
            expired = None
            if req.ttft_deadline_s is not None and waited > req.ttft_deadline_s:
                expired = (
                    f"shed in queue: TTFT deadline {req.ttft_deadline_s}s "
                    f"expired after {waited:.3f}s waiting"
                )
            elif req.deadline_s is not None and waited > req.deadline_s:
                expired = (
                    f"shed in queue: deadline {req.deadline_s}s expired "
                    f"after {waited:.3f}s waiting"
                )
            if expired is None:
                keep.append(req)
            else:
                self.counters["shed"] += 1
                self._terminal(rec, RequestState.SHED, expired)
        self.queue = keep
        for slot, tenant in enumerate(self._tenants):
            if tenant is None:
                continue
            req = tenant.req
            rec = self.outcomes[req.rid]
            age = now - rec.submitted_at
            if req.deadline_s is not None and age > req.deadline_s:
                self.counters["timed_out"] += 1
                self._evict(
                    slot,
                    RequestState.TIMED_OUT,
                    f"deadline {req.deadline_s}s exceeded after {len(tenant.emitted)} tokens",
                )
            elif (
                req.ttft_deadline_s is not None
                and rec.first_token_at is None
                and age > req.ttft_deadline_s
            ):
                self.counters["timed_out"] += 1
                self._evict(
                    slot,
                    RequestState.TIMED_OUT,
                    f"TTFT deadline {req.ttft_deadline_s}s exceeded before first token",
                )

    def _with_retry(self, fn, what: str):
        """Bounded exponential-backoff retry around one engine dispatch.
        Sound because a failed dispatch leaves the slot state as it was
        (``Engine.decode_slots`` commits at the end of a chunk; an admission
        only writes a free slot)."""
        delay = self.backoff_s
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — retry, then re-raise below
                last = e
                if attempt < self.retries:
                    self.counters["retries"] += 1
                    self._sleep(delay)
                    delay *= 2
        raise DispatchError(f"{what} failed after {self.retries + 1} attempt(s): {last!r}") from last

    # -- scheduling ----------------------------------------------------------

    def _record_tokens(self, tenant: _Tenant, new: List[int]) -> bool:
        """Append a chunk's emitted tokens to the tenant, cut after a stop
        token (kept), and stream exactly those. True if a stop token ended
        the request."""
        rec = self.outcomes[tenant.req.rid]
        stopped = False
        if tenant.stop:
            for i, t in enumerate(new):
                if t in tenant.stop:
                    new = new[: i + 1]
                    stopped = True
                    break
        if new:
            if rec.first_token_at is None:
                rec.first_token_at = self._clock()
            tenant.emitted.extend(new)
            rec.n_tokens = len(tenant.emitted)
            if self.on_tokens is not None:
                self.on_tokens(tenant.req.rid, list(new))
        return stopped

    def _finish(self, slot: int, *, stopped: bool) -> Completion:
        """FINISH a tenant (budget exhausted or stop token). An early stop
        releases the slot; budget exhaustion already deactivated the row."""
        tenant = self._tenants[slot]
        assert tenant is not None
        if stopped:
            self.counters["stopped_early"] += 1
            self.slots = self.engine.release_slot(self.slots, slot)
        self._terminal(
            self.outcomes[tenant.req.rid],
            RequestState.FINISHED,
            "stop token" if stopped else "budget exhausted",
            tokens=tenant.emitted,
        )
        self._tenants[slot] = None  # freed; refilled at the next chunk boundary
        return Completion(
            rid=tenant.req.rid,
            prompt=tenant.req.prompt,
            new_tokens=np.asarray(tenant.emitted, np.int32),
            admitted_at_step=tenant.admitted_at_step,
            finished_at_step=self.decode_steps,
            stopped=stopped,
        )

    def _install_tenant(self, slot: int, req: Request) -> Optional[Completion]:
        """After a successful admission: the DECODING transition and the
        tenant; in spec mode also the first token, sampled at admission, which
        completes a budget-1 request right here."""
        rec = self.outcomes[req.rid]
        rec.prefill_chunks = 1
        rec.transition(RequestState.DECODING, self._clock())
        tenant = _Tenant(req, self.decode_steps)
        self._tenants[slot] = tenant
        if self.speculate is not None:
            stopped = self._record_tokens(tenant, [int(self.slots["t_pend"][slot])])
            if stopped or len(tenant.emitted) >= req.max_new_tokens:
                return self._finish(slot, stopped=stopped)
        return None

    def _admit_free_slots(self) -> List[Completion]:
        """Fill free slots from the queue. A prefill that keeps failing
        fails only its request; the slot stays free for the next one. In
        spec mode a request done at admission (budget 1, or a stop token
        first) is returned, and its slot refills in the same round."""
        done: List[Completion] = []
        for slot in range(self.n_slots):
            while self.queue and self._tenants[slot] is None:
                req = self.queue.popleft()
                rec = self.outcomes[req.rid]
                rec.transition(RequestState.PREFILLING, self._clock())

                def dispatch(req=req, slot=slot):
                    if self.faults is not None:
                        self.faults.on_prefill(req.rid)
                    return self.engine.admit_slot(
                        self.slots,
                        slot,
                        req.prompt,
                        max_new_tokens=req.max_new_tokens,
                        temperature=req.temperature,
                        seed=req.seed,
                        speculate=req.speculate is not False,
                    )

                try:
                    self.slots = self._with_retry(
                        dispatch, what=f"admission prefill (request {req.rid})"
                    )
                except DispatchError as e:
                    self.counters["failed"] += 1
                    self._terminal(rec, RequestState.FAILED, str(e))
                    continue  # the slot is still free: try the next request
                c = self._install_tenant(slot, req)
                if c is not None:
                    done.append(c)
        return done

    def _harvest(self, slot: int) -> Optional[Completion]:
        tenant = self._tenants[slot]
        if tenant is None or len(tenant.emitted) < tenant.req.max_new_tokens:
            return None
        assert len(tenant.emitted) == tenant.req.max_new_tokens, (
            "the slot's active mask emitted past the request budget"
        )
        return self._finish(slot, stopped=False)

    def _dispatch_decode(self):
        """One decode chunk with fault injection and bounded retry. Returns
        ``(tokens, valid, slots)``, or None after exhausted retries — then
        every active tenant is FAILED and the slot state rebuilt so queued
        requests still serve."""
        ordinal = self._chunk_ordinal
        self._chunk_ordinal += 1

        def dispatch():
            if self.faults is not None:
                self.faults.on_chunk(ordinal)
            if self.speculate is None:
                return self.engine.decode_slots(self.slots, self.chunk)
            return self.engine.spec_decode_slots(self.slots, self.chunk)

        try:
            return self._with_retry(dispatch, what=f"decode chunk {ordinal}")
        except DispatchError as e:
            self.counters["decode_dispatch_failures"] += 1
            for slot, tenant in enumerate(self._tenants):
                if tenant is None:
                    continue
                self.counters["failed"] += 1
                self._terminal(
                    self.outcomes[tenant.req.rid], RequestState.FAILED, str(e),
                    tokens=tenant.emitted,
                )
                self._tenants[slot] = None
            self.slots = self.engine.init_slots(self.n_slots, speculate=self.speculate)
            return None

    def _inject_and_guard_nan(self) -> None:
        """After a chunk: the FaultPlan poisons due rows, then the guard
        fails and quarantines every non-finite row."""
        if self.faults is not None:
            for slot, tenant in enumerate(self._tenants):
                if tenant is not None and self.faults.poison_due(tenant.req.rid, len(tenant.emitted)):
                    self.slots = self.engine.poison_logit_row(self.slots, slot)
        if not self.nan_guard:
            return
        occupied = [s for s, t in enumerate(self._tenants) if t is not None]
        if not occupied:
            return
        finite = self.engine.finite_logit_rows(self.slots)
        for slot in occupied:
            if not finite[slot]:
                self.counters["nan_quarantined"] += 1
                self.counters["failed"] += 1
                self._evict(
                    slot,
                    RequestState.FAILED,
                    "non-finite logits: row quarantined (slot scrubbed; neighbours unaffected)",
                )

    def step(self) -> List[Completion]:
        """One chunk boundary: apply cancels, enforce deadlines, admit into
        free slots, run one decode chunk, harvest completions, guard NaNs."""
        done: List[Completion] = []
        self._apply_cancels()
        self._enforce_deadlines()
        done.extend(self._admit_free_slots())
        if self.n_active == 0:
            return done
        res = self._dispatch_decode()
        if res is None:
            return done
        toks, valid, self.slots = res
        self.decode_steps += self.chunk
        if self.speculate is not None:
            self.chunk_rows += self.n_active * self.chunk
        self.steps_active += int(valid.sum())
        for slot, tenant in enumerate(self._tenants):
            if tenant is None:
                continue
            stopped = self._record_tokens(tenant, [int(t) for t in toks[slot][valid[slot]]])
            if stopped:
                done.append(self._finish(slot, stopped=True))
            else:
                c = self._harvest(slot)
                if c is not None:
                    done.append(c)
        self._inject_and_guard_nan()
        return done

    def run(self, max_chunks: int = 100_000) -> List[Completion]:
        """Drain the queue; completions in finish order. Requests that end
        CANCELLED / TIMED_OUT / FAILED / SHED produce no Completion — read
        their records from ``outcomes`` (or stream them via ``on_event``)."""
        out: List[Completion] = []
        for _ in range(max_chunks):
            if self.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"scheduler did not drain within {max_chunks} chunks")
