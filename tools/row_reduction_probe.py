#!/usr/bin/env python3
"""Whether a row's sum over its last axis depends on how many rows share the
call, on one CUDA GPU: ``torch.mean`` (what ``rmsnorm`` used before) against
``repro_torch.utils.row_sum`` (what it uses now), and ``rmsnorm`` itself.

    python3 tools/row_reduction_probe.py [--out chiprun_out/row_reduction_probe.json]

For d in {256, 3072} (a reduced model's and llama3.2-3b's d_model) and f32
and bf16 inputs, 64 random rows are reduced alone and in calls of N rows; it
prints, for each N, how many of the N rows differ from the row alone (the
mean of squares as ``rmsnorm`` forms it, and ``rmsnorm``'s output).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ROWS = (1, 2, 4, 5, 8, 9, 16, 20, 45, 64)


def differ(fn, x, n):
    """Rows of ``fn(x[:n])`` that differ from ``fn`` of the row alone."""
    alone = torch.cat([fn(x[i : i + 1]) for i in range(n)])
    return int((fn(x[:n]) != alone).flatten(1).any(-1).sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_reduction_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models.layers import rmsnorm
    from repro_torch.utils import row_sum

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"card": card, "torch": torch.__version__, "rows": ROWS, "results": []}
    for d in (256, 3072):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((64, 1, d), generator=gen, device="cuda").to(dtype)
            w = torch.ones((d,), dtype=dtype, device="cuda")
            fns = {
                "torch.mean": lambda t: torch.mean(t.float() * t.float(), dim=-1, keepdim=True),
                "row_sum": lambda t: row_sum(t.float() * t.float()),
                "rmsnorm": lambda t: rmsnorm(w, t),
            }
            for name, fn in fns.items():
                counts = [differ(fn, x, n) for n in ROWS]
                out["results"].append({"d": d, "dtype": str(dtype)[6:], "fn": name, "rows_differ": counts})
                print(f"d={d} {str(dtype)[6:]:8s} {name:10s} rows differing from the row alone at N={ROWS}: {counts}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
