"""The training loop: checkpoint and restart, preemption, straggler
detection (counterpart of ``repro/train/loop.py``, with its semantics):

- resume by default from the newest complete checkpoint; like the
  reference, a resumed run restarts its batch iterator (no data skipping);
- SIGTERM / SIGINT → a final checkpoint → a clean exit (preemption);
- an async checkpoint writer (the step loop does not wait on the disk);
- a step-time EMA watchdog that logs and counts slow steps.

A step's wall is taken after a sync on the loss's device (the reference
blocks until the loss is ready).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0  # a step slower than EMA·factor is an anomaly


class StragglerDetector:
    """EMA step-time watchdog (the single-process stand-in for fleet-level
    straggler handling)."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.count = 0
        self.anomalies = 0

    def observe(self, dt: float) -> bool:
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        slow = self.count > self.warmup and dt > self.factor * self.ema
        if slow:
            self.anomalies += 1
        else:
            self.ema = 0.9 * self.ema + 0.1 * dt
        return slow


class PreemptionGuard:
    """Turns SIGTERM / SIGINT into a cooperative stop flag."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
                signal.signal(signal.SIGINT, self._handler)
            except ValueError:
                pass  # not in the main thread

    def _handler(self, signum, frame):
        self.requested = True


def _wait(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def train_loop(
    train_step: Callable,
    params,
    opt_state,
    batches: Iterator[dict],
    loop_cfg: LoopConfig,
    *,
    log: Callable[[str], None] = print,
    guard: Optional[PreemptionGuard] = None,
) -> tuple:
    """Run to ``total_steps`` (resuming included). Returns (params, opt,
    history), history the (step, loss) of every logged step."""
    start_step = 0
    async_ckpt = None
    if loop_cfg.ckpt_dir:
        latest = ckpt_lib.latest_step(loop_cfg.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(loop_cfg.ckpt_dir, latest, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            log(f"[restore] resumed from step {latest}")
        async_ckpt = ckpt_lib.AsyncCheckpointer(loop_cfg.ckpt_dir, keep=loop_cfg.keep)

    guard = guard or PreemptionGuard(install=False)
    detector = StragglerDetector(loop_cfg.straggler_factor)
    history = []

    completed = start_step
    for step in range(start_step, loop_cfg.total_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        _wait(metrics["loss"])
        completed = step + 1
        dt = time.perf_counter() - t0
        if detector.observe(dt):
            log(f"[straggler] step {step}: {dt:.3f}s vs EMA {detector.ema:.3f}s")
        if step % loop_cfg.log_every == 0:
            loss = float(metrics["loss"])
            history.append((step, loss))
            log(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if async_ckpt and completed % loop_cfg.ckpt_every == 0:
            async_ckpt.submit(completed, {"params": params, "opt": opt_state})
        if guard.requested:
            log(f"[preempt] signal at step {step}; checkpointing and exiting")
            break

    if loop_cfg.ckpt_dir:
        async_ckpt.close()
        ckpt_lib.save(loop_cfg.ckpt_dir, completed, {"params": params, "opt": opt_state}, keep=loop_cfg.keep)
    return params, opt_state, history
