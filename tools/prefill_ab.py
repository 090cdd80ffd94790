#!/usr/bin/env python3
"""Admission prefill time of full-width llama3.2-3b on the GPU, dense bf16
and ``dequant`` (q=4 g=128), for several source trees of the port in turns,
inside one run.

    python3 tools/prefill_ab.py --tree parent=DIR --tree change=. [--lens 512 8192]

Each ``--tree NAME=DIR`` names a directory holding ``src/repro_torch`` (for
example a ``git archive`` of another commit, unpacked). The trees run in
turns, forward then backward (``--rounds`` times each way), one process per
turn, so a host that slows down over the run weighs on every tree alike. A
process builds the dense model from seed 0 on the card and its ``dequant``
copy (one solver iteration: the weights' values do not change the time),
and for each model and prompt length times ``Engine.admit_slot`` of one
prompt into a fresh 1-slot batch (host clock, the device synchronised
before and after), once untimed, then ``REPS`` times. This is the prefill
a serving user waits for before the first token, the sampling of that
token included. It prints one line per turn, a table of medians, and
writes everything to ``chiprun_out/prefill_ab.json``. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 5


def child(lens) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import init_params
    from repro_torch.quant import QuantPolicy, quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-3b")
    dense = init_params(cfg, seed=0, device="cuda")
    models = {"dense": dense,
              "dequant": quantize_params(dense, QuantPolicy(q=4, g=128, iters=1, fmt="dequant"), device="cuda")}
    rng = np.random.default_rng(0)
    prompts = {n: rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens}
    out = {}
    for name, params in models.items():
        engine = Engine(cfg, params, max_seq=max(lens) + 8, device="cuda")
        for n, prompt in prompts.items():
            ms = []
            for i in range(REPS + 1):
                slots = engine.init_slots(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.admit_slot(slots, 0, prompt, max_new_tokens=1)
                torch.cuda.synchronize()
                if i:
                    ms.append((time.perf_counter() - t0) * 1e3)
                del slots
            out[f"{name} S={n}"] = ms
        del engine
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR, a tree holding src/repro_torch")
    ap.add_argument("--lens", type=int, nargs="+", default=[512, 8192])
    ap.add_argument("--rounds", type=int, default=1, help="forward-and-backward passes over the trees")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.lens)
        return 0
    if not args.tree:
        ap.error("name at least one --tree")
    trees = [t.split("=", 1) for t in args.tree]
    order = (trees + trees[::-1]) * args.rounds
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for name, d in order:
        env = dict(os.environ, PYTHONPATH=str((Path(d) / "src").resolve()))
        cmd = [sys.executable, __file__, "--child", "--lens", *map(str, args.lens)]
        res = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"prefill_ab: tree {name} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, "ms": got})
        print(f"  {name:10s} " + "  ".join(f"{k}: {statistics.median(v):.2f} ms" for k, v in got.items()),
              flush=True)
    table = {}
    for name, _ in trees:
        for key in runs[0]["ms"]:
            ms = statistics.median(x for r in runs if r["tree"] == name for x in r["ms"][key])
            table[f"{name} {key}"] = ms
            print(f"{name:10s} {key:16s} median {ms:.2f} ms", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "prefill_ab.json").write_text(json.dumps(
        {"card": card, "reps": REPS, "runs": runs, "medians": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
