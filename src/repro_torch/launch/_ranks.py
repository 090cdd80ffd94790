"""Start the ranks of a tensor-parallel run (counterpart of
``repro/launch/_hostdev.py``: where the JAX package forces N host devices
into one process before its first JAX call, the port starts N processes,
one a rank, joined by one ``torch.distributed`` process group).

:func:`run_ranks` spawns the ranks with ``torch.multiprocessing`` (the
spawn start method: a fresh interpreter a rank, so no CUDA state is
forked), meets them through ``init_method="file://..."`` in a temporary
directory of its own (no TCP port, so parallel runs never collide), calls
``fn(rank, n, *args)`` in each and returns their results in rank order.

Device rule (:func:`placement`), printed by rank 0:

- rank ``r`` computes on ``cuda:(r % device_count)``;
- the backend is NCCL when every rank has a card of its own, else gloo
  (ranks that share a card: NCCL refuses two ranks of one communicator on
  one GPU; gloo moves CUDA tensors through host memory);
- ``device="cpu"`` runs every rank on the host, over gloo.

This is a stated rule, not a fallback: a collective, a kernel or a rank
that fails raises. Every rendezvous and collective has a timeout, and a
rank that fails, dies or outlives ``timeout`` makes :func:`run_ranks` kill
the others and raise.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Sequence, Tuple

import torch

DEFAULT_TIMEOUT_S = 600.0


def placement(n: int, device: str = "cuda") -> Tuple[str, List[str]]:
    """``(backend, each rank's device)`` for ``n`` ranks by the rule above."""
    if n < 1:
        raise ValueError(f"tensor parallelism needs >= 1 rank, got {n}")
    if torch.device(device).type == "cpu":
        return "gloo", ["cpu"] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            f"{n} ranks on {device!r} requested but torch.cuda.device_count() is 0; "
            "pass device='cpu' to run the ranks on the host"
        )
    return ("nccl" if count >= n else "gloo"), [f"cuda:{r % count}" for r in range(n)]


def rank_threads(n: int) -> int:
    """A rank's intra-op threads: the host's cores shared out among the
    ``n`` ranks (at least one), so their thread pools do not oversubscribe
    the cores."""
    return max(1, (os.cpu_count() or 1) // n)


def describe(n: int, device: str = "cuda") -> str:
    """The device rule's verdict for ``n`` ranks, one line."""
    backend, devices = placement(n, device)
    why = {"nccl": "every rank has a card of its own",
           "gloo": "the ranks run on the host" if devices[0] == "cpu" else
                   "ranks share a card, which NCCL refuses; gloo moves CUDA tensors through host memory"}
    return f"tensor-parallel: {n} ranks on {devices}, backend {backend} ({why[backend]})"


def _rank_main(rank, n, backend, devices, init_file, timeout_s, fn, args, results):
    import torch.distributed as dist

    try:
        torch.set_num_threads(rank_threads(n))
        if devices[rank].startswith("cuda"):
            torch.cuda.set_device(devices[rank])
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            if rank == 0:
                print(describe(n, devices[0].split(":")[0]), flush=True)
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which kills the other ranks
        results.put((rank, False, traceback.format_exc()))
        raise


def _failures(results, failed: dict) -> str:
    """The report of a failed run: the first failure and any other rank's
    that arrives within a second of the last (a rank whose peer died fails
    in its next collective, so the first report need not be the cause)."""
    while True:
        try:
            rank, good, value = results.get(timeout=1.0)
        except queue_mod.Empty:
            break
        if not good:
            failed[rank] = value
    body = "\n".join(f"--- rank {r} ---\n{v}" for r, v in sorted(failed.items()))
    return f"tensor-parallel run: ranks {sorted(failed)} failed:\n{body}"


def run_ranks(fn: Callable, n: int, args: Sequence = (), *, device: str = "cuda",
              timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, n, *args)`` in ``n`` spawned ranks of one process
    group → their results in rank order. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function); ``timeout`` bounds the whole run, the
    rendezvous and every collective."""
    import torch.multiprocessing as mp

    backend, devices = placement(n, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_tp_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, name=f"tp-rank-{r}",
                             args=(r, n, backend, devices, init_file, timeout, fn, tuple(args), results))
                 for r in range(n)]
        for p in procs:
            p.start()
        out, ok = {}, False
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"tensor-parallel run: ranks {sorted(set(range(n)) - set(out))} "
                                       f"did not finish within {timeout:.0f}s")
                try:
                    rank, good, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"tensor-parallel run: ranks exited without a result "
                                           f"(rank, exit code): {dead}")
                    continue
                if not good:
                    raise RuntimeError(_failures(results, {rank: value}))
                out[rank] = value
            ok = True
        finally:
            for p in procs:
                if not ok and p.is_alive():
                    p.kill()
                p.join(timeout=None if not ok else 60)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]
