#!/usr/bin/env python3
"""Decode-step time of full-width llama3.2-3b (bcq q=4 g=128, bf16) on the GPU,
for several source trees of the port in turns, inside one run.

    python3 tools/decode_ab.py --tree parent=DIR --tree change=. [--batches 4 64]

Each ``--tree NAME=DIR`` names a directory holding ``src/repro_torch`` (for
example a ``git archive`` of another commit, unpacked). The trees run in
turns, forward then backward (``--rounds`` times each way), one process per
turn, so a host that slows down over the run weighs on every tree alike. A
process builds the model from seed 0 on the card, quantizes it, prefills
``B`` prompts of 16 tokens into a cache of ``--max-seq`` rows and times 16
decode steps (``Engine.decode``) after one untimed step, for each batch size;
it also compares batch row 0's prefill and first decode logits with the same
prompt run alone (batch invariance, max|Δ|). It prints one line per turn, a table of medians, and writes everything to
``chiprun_out/decode_ab.json``. Needs one CUDA GPU.
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
PROMPT_LEN, STEPS = 16, 16


def child(batches, max_seq) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import init_params
    from repro_torch.quant import QuantPolicy, quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-3b")
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), QuantPolicy(q=4, g=128, iters=4, fmt="bcq"),
                             device="cuda")
    engine = Engine(cfg, params, max_seq=max_seq, device="cuda")
    rng = np.random.default_rng(0)
    out = {}
    for b in batches:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, PROMPT_LEN)), device="cuda")
        logits, cache = engine.prefill(toks, engine._make_cache(b))
        tok = torch.argmax(logits, -1)[:, None]
        # row 0 of the batch against the same prompt alone: prefill and first decode logits
        solo0, solo = engine.prefill(toks[:1], engine._make_cache(1))
        solo1, _ = engine.decode(tok[:1], solo, PROMPT_LEN)
        steps = []
        for i in range(STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prev = logits
            logits, cache = engine.decode(tok, cache, PROMPT_LEN + i)
            tok = torch.argmax(logits, -1)[:, None]
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                row0 = [(prev[0] - solo0[0]).abs().max().item(), (logits[0] - solo1[0]).abs().max().item()]
        out[b] = {"steps_ms": steps[1:], "row0_vs_solo": row0}
        del cache, solo
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR, a tree holding src/repro_torch")
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 64])
    ap.add_argument("--max-seq", type=int, default=536)
    ap.add_argument("--rounds", type=int, default=1, help="forward-and-backward passes over the trees")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.batches, args.max_seq)
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
        cmd = [sys.executable, __file__, "--child", "--max-seq", str(args.max_seq),
               "--batches", *map(str, args.batches)]
        res = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"decode_ab: tree {name} failed")
        got = {int(b): v for b, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}
        steps = {b: v["steps_ms"] for b, v in got.items()}
        runs.append({"tree": name, "steps_ms": steps, "row0_vs_solo": {b: v["row0_vs_solo"] for b, v in got.items()}})
        print(f"  {name:10s} " + "  ".join(
            f"B={b}: {statistics.median(v['steps_ms']):.2f} ms/step, row 0 vs alone: prefill logits "
            f"{v['row0_vs_solo'][0]:.3e}, decode {v['row0_vs_solo'][1]:.3e}" for b, v in got.items()), flush=True)
    table = {}
    for name, _ in trees:
        for b in args.batches:
            ms = statistics.median(x for r in runs if r["tree"] == name for x in r["steps_ms"][b])
            table[f"{name} B={b}"] = {"ms_per_step": ms, "tok_s": b * 1e3 / ms}
            print(f"{name:10s} B={b:<3d} median {ms:.2f} ms/step, {b * 1e3 / ms:.1f} tok/s", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_ab.json").write_text(json.dumps(
        {"card": card, "max_seq": args.max_seq, "prompt_len": PROMPT_LEN, "steps": STEPS, "runs": runs,
         "medians": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
