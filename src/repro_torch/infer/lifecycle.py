"""Request-lifecycle state machine for the serving stack (the port's own
copy of ``repro/infer/lifecycle.py``, numpy only; DESIGN.md §9).

The scheduler's correctness contract (DESIGN.md §4) covers the happy path —
every request runs its full budget and the interleaving is invisible. Real
traffic is not the happy path: clients cancel and disconnect, deadlines
expire, queues flood, and a single poisoned row must not take the batch down.
This module gives every request an explicit, *validated* state machine::

    QUEUED ──► PREFILLING ──► DECODING ──► FINISHED
      │   │         ├──► CANCELLED        ├──► CANCELLED    (client cancel/disconnect)
      │   │         ├──► TIMED_OUT        ├──► TIMED_OUT    (TTFT or wall-clock deadline)
      │   │         └──► FAILED           └──► FAILED       (dispatch/NaN quarantine)
      │   └──► CANCELLED   (cancelled while queued)
      └──► SHED            (deadline-aware queue shedding)

plus a :class:`QueueFullError` raised at submit time when the bounded
admission queue is full (backpressure is a *loud reject with a reason*, never
unbounded growth). Terminal states are terminal — a second transition out of
them is a scheduler bug and raises :class:`TransitionError` immediately
rather than corrupting accounting.

Every record carries the timestamps the serving metrics need (submit, admit,
first token, finish, measured against the scheduler's injectable clock), so
TTFT/TPOT percentiles (:func:`latency_summary`) fall out of the same
bookkeeping that drives the state machine.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"
    SHED = "shed"

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL


_TERMINAL = {
    RequestState.FINISHED,
    RequestState.CANCELLED,
    RequestState.TIMED_OUT,
    RequestState.FAILED,
    RequestState.SHED,
}

# Allowed transitions. PREFILLING -> CANCELLED/TIMED_OUT exists for the
# chunked-prefill path (DESIGN.md §12): a long-prompt admission spans many
# scheduler steps, and cancels/deadlines land at the step boundaries between
# its chunks. Synchronous (unchunked) admission still can't observe them
# mid-prefill — it is one host call — so there they fire on either side.
_ALLOWED: Dict[RequestState, set] = {
    RequestState.QUEUED: {
        RequestState.PREFILLING,
        RequestState.CANCELLED,
        RequestState.SHED,
    },
    RequestState.PREFILLING: {
        RequestState.DECODING,
        RequestState.CANCELLED,
        RequestState.TIMED_OUT,
        RequestState.FAILED,
    },
    RequestState.DECODING: {
        RequestState.FINISHED,
        RequestState.CANCELLED,
        RequestState.TIMED_OUT,
        RequestState.FAILED,
    },
}


class TransitionError(RuntimeError):
    """An illegal lifecycle transition — always a scheduler bug, never data."""


class QueueFullError(RuntimeError):
    """Admission queue is at capacity; the request was NOT enqueued.

    Raised by ``Scheduler.submit`` (and surfaced as a rejection event by the
    async server) so backpressure is visible to the caller instead of
    manifesting as unbounded queue growth.
    """


@dataclasses.dataclass
class RequestLifecycle:
    """Per-request lifecycle record: validated state + latency timestamps.

    ``new_tokens`` is populated at every terminal transition with whatever
    the request emitted — the full completion for FINISHED, the partial
    prefix for CANCELLED/TIMED_OUT/FAILED (a failed request's partial tokens
    are still useful for debugging the failure), empty for SHED.
    """

    rid: int
    state: RequestState = RequestState.QUEUED
    reason: str = ""
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    n_tokens: int = 0
    new_tokens: Optional[np.ndarray] = None
    # prefix-cache / chunked-prefill stamps (DESIGN.md §12): prompt tokens
    # served from cached KV at admission, and how many prefill dispatches
    # the admission took (1 = whole-shot)
    prefix_hit_tokens: int = 0
    prefill_chunks: int = 0
    history: List[Tuple[RequestState, float]] = dataclasses.field(
        default_factory=list
    )

    def transition(self, new: RequestState, at: float, reason: str = "") -> None:
        allowed = _ALLOWED.get(self.state, set())
        if new not in allowed:
            raise TransitionError(
                f"request {self.rid}: illegal transition "
                f"{self.state.value} -> {new.value}"
                + (f" (from terminal state)" if self.state.terminal else "")
            )
        self.state = new
        self.history.append((new, at))
        if reason:
            self.reason = reason
        if new is RequestState.PREFILLING:
            self.admitted_at = at
        if new.terminal:
            self.finished_at = at

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first emitted token (chunk-boundary resolution)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.first_token_at is None or self.finished_at is None:
            return None
        if self.n_tokens < 2:
            return None
        return (self.finished_at - self.first_token_at) / (self.n_tokens - 1)


def _pcts(values: List[Optional[float]]) -> Dict[str, Optional[float]]:
    """Percentile block over the *finite* values. Always a dict — an empty
    or all-excluded stream yields explicit nulls with ``n == 0`` (never
    ``None`` in place of the block, never a NaN percentile), so consumers
    can subscript unconditionally and nulls survive JSON round-trips.
    ``excluded`` counts what was dropped (None entries from requests that
    never produced the measurement, plus any non-finite values)."""
    finite = [v for v in values if v is not None and np.isfinite(v)]
    excluded = len(values) - len(finite)
    if not finite:
        return {
            "p50": None, "p95": None, "p99": None, "mean": None,
            "n": 0, "excluded": excluded,
        }
    v = np.asarray(finite, np.float64)
    return {
        "p50": float(np.percentile(v, 50)),
        "p95": float(np.percentile(v, 95)),
        "p99": float(np.percentile(v, 99)),
        "mean": float(v.mean()),
        "n": len(finite),
        "excluded": excluded,
    }


def latency_summary(records: Iterable[RequestLifecycle]) -> dict:
    """TTFT/TPOT p50/p95/p99 over finished requests + terminal-state counts.

    TTFT/TPOT are measured at chunk-boundary resolution (tokens become
    visible to the host when a decode chunk returns), so ``chunk=1`` gives
    exact per-token latencies and larger chunks overstate TTFT by at most
    one chunk's wall time — the same resolution a streaming client observes.

    Edge cases are explicit, never NaN: with zero finished requests the
    ``ttft_s``/``tpot_s`` blocks still exist with null percentiles and
    ``n == 0``; a single-token completion has no TPOT (``tpot_s`` counts it
    under ``excluded``); requests that never reached a first token are
    tallied in ``no_first_token`` instead of silently vanishing from the
    percentile population.
    """
    records = list(records)
    by_state: Dict[str, int] = {}
    for r in records:
        by_state[r.state.value] = by_state.get(r.state.value, 0) + 1
    fin = [r for r in records if r.state is RequestState.FINISHED]
    return {
        "requests": len(records),
        "by_state": by_state,
        "finished": len(fin),
        # terminal without ever emitting: cancelled/timed-out/failed before
        # the first chunk returned (a FINISHED request always has one)
        "no_first_token": sum(
            1
            for r in records
            if r.state.terminal and r.first_token_at is None
        ),
        "ttft_s": _pcts([r.ttft for r in fin]),
        "tpot_s": _pcts([r.tpot for r in fin]),
    }
