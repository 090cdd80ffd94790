#!/usr/bin/env python3
"""What one collective of a tensor-parallel decode step costs when two ranks
share one CUDA GPU over gloo (``launch/_ranks.py``'s rule), and what sets it.

    python3 tools/tp_collectives_probe.py [--ranks 2] [--out chiprun_out/tp_collectives_probe.json]

Each rank times, with the host's clock over ``REPS`` calls after a warm-up,
the two collectives of llama3.2-3b's B = 4 decode step
(``parallel/ctx.py``): the all-reduce of a (4, 1, 3072) bf16 partial sum
and the all-gather of a (4, 1, 64128) f32 logits shard, on CUDA tensors
(what the engine passes) and on host tensors (no copy between card and
host), at the torch's default intra-op thread count and at
``launch/_ranks.py``'s rank setting, and a copy of the partial sum to the
host and back alone. It prints ms a call per case and rank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 200


def _ms(fn, reps=REPS):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def probe(rank, n, threads):
    import torch.distributed as dist

    out = {}
    part = torch.randn((4, 1, 3072), device="cuda").to(torch.bfloat16)
    shard = torch.randn((4, 1, 64128), device="cuda")
    for label, t in threads.items():
        torch.set_num_threads(t)
        for where in ("cuda", "cpu"):
            x, y = part.to(where), shard.to(where)
            parts = [torch.empty_like(y) for _ in range(n)]
            dist.barrier()
            out[f"all_reduce {where}, {label} ({t} threads)"] = _ms(lambda: dist.all_reduce(x))
            dist.barrier()
            out[f"all_gather {where}, {label} ({t} threads)"] = _ms(lambda: dist.all_gather(parts, y))
        dist.barrier()
        out[f"copy to the host and back, {label} ({t} threads)"] = _ms(lambda: part.cpu().to("cuda"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_collectives_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.launch._ranks import describe, rank_threads, run_ranks

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    print(describe(args.ranks))
    threads = {"torch's default": torch.get_num_threads(), "the rank setting": rank_threads(args.ranks)}
    results = run_ranks(probe, args.ranks, (threads,), device="cuda", timeout=600)
    for rank, res in enumerate(results):
        for case, ms in res.items():
            print(f"rank {rank}  {case:60s} {ms:.4f} ms a call")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "cpus": os.cpu_count(), "ranks": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
