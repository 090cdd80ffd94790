"""Deterministic fault injection for the serving stack (the port's own copy
of ``repro/infer/faults.py``, stdlib only; DESIGN.md §9).

Every degradation path the hardened scheduler claims to handle — prefill
dispatch failures, decode-chunk dispatch failures, NaN-poisoned logit rows,
slow clients, queue floods — must be *demonstrable*, not theoretical. A
:class:`FaultPlan` is threaded through the scheduler's dispatch points (and
the async server's client-facing stream) and fires its faults at exact,
reproducible points:

- ``fail_prefill={rid: n}`` — the admission prefill for request ``rid``
  raises :class:`InjectedFault` on its first ``n`` attempts (``n=-1`` →
  every attempt, i.e. a permanent failure). Retries re-consult the plan, so
  ``n <= retries`` exercises recover-after-retry and ``n = -1`` exercises
  the quarantine path.
- ``fail_chunk={ordinal: n}`` — the ``ordinal``-th decode-chunk dispatch
  (0-based, counted over the scheduler's lifetime) raises on its first
  ``n`` attempts.
- ``nan_row={rid: k}`` — once request ``rid`` has emitted ``>= k`` tokens,
  its logits row is overwritten with NaN at the next chunk boundary; the
  scheduler's NaN/inf guard must then quarantine exactly that row.
- ``client_stall={rid: seconds}`` — the async server sleeps this long
  before forwarding each event of ``rid`` to its client, simulating a slow
  consumer (exercises the bounded per-stream buffer policy).

Faults are injected *host-side, before (or between) engine dispatches* —
never inside a kernel launch or a forward. This matters for retry
soundness: an injected failure raises before the engine touches the slot
state, so the state is intact and the retry is exact. The plan mutates as it
fires (countdowns decrement, one-shot faults mark themselves done); build a
fresh plan per run.

:class:`StepClock` is the companion fake clock: deadlines and backoff are
wall-clock quantities, so the scheduler takes injectable ``clock``/``sleep``
callables and the tests drive them deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


class InjectedFault(RuntimeError):
    """A fault fired by a FaultPlan (stands in for a transient launch or
    dispatch failure at exactly the point the plan names)."""


@dataclasses.dataclass
class FaultPlan:
    fail_prefill: Dict[int, int] = dataclasses.field(default_factory=dict)
    fail_chunk: Dict[int, int] = dataclasses.field(default_factory=dict)
    nan_row: Dict[int, int] = dataclasses.field(default_factory=dict)
    client_stall: Dict[int, float] = dataclasses.field(default_factory=dict)

    # counters the tests/benchmarks read back
    fired_prefill: int = 0
    fired_chunk: int = 0
    fired_nan: int = 0

    def on_prefill(self, rid: int) -> None:
        """Called per admission-prefill *attempt* for request ``rid``."""
        left = self.fail_prefill.get(rid, 0)
        if left == 0:
            return
        if left > 0:
            self.fail_prefill[rid] = left - 1
        self.fired_prefill += 1
        raise InjectedFault(f"injected prefill failure for request {rid}")

    def on_chunk(self, ordinal: int) -> None:
        """Called per decode-chunk dispatch *attempt*; ``ordinal`` counts
        dispatched chunks over the scheduler's lifetime."""
        left = self.fail_chunk.get(ordinal, 0)
        if left == 0:
            return
        if left > 0:
            self.fail_chunk[ordinal] = left - 1
        self.fired_chunk += 1
        raise InjectedFault(f"injected decode failure at chunk {ordinal}")

    def poison_due(self, rid: int, n_emitted: int) -> bool:
        """True exactly once: when ``rid`` has emitted >= its threshold."""
        k = self.nan_row.get(rid)
        if k is None or n_emitted < k:
            return False
        del self.nan_row[rid]  # fire once
        self.fired_nan += 1
        return True

    def stall_for(self, rid: int) -> float:
        return self.client_stall.get(rid, 0.0)


class StepClock:
    """Deterministic clock for deadline tests: advances ``dt`` per reading.

    ``sleep`` advances the clock by the requested amount without real waiting,
    so backoff paths are exact and instant under test.
    """

    def __init__(self, dt: float = 0.0, start: float = 0.0):
        self.now = start
        self.dt = dt
        self.slept: float = 0.0

    def __call__(self) -> float:
        t = self.now
        self.now += self.dt
        return t

    def sleep(self, seconds: float) -> None:
        self.now += seconds
        self.slept += seconds

    def advance(self, seconds: float) -> None:
        self.now += seconds
