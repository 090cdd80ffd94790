#!/usr/bin/env python3
"""Per-leaf times of quantized-matmul kernels at llama3.2-3b's shapes (q=4,
g=128, bf16 x and scales) for several source trees of the port in turns,
inside one run.

    python3 tools/kernel_ab.py --tree parent=DIR --tree change=. \\
        [--kernels bcq_mm bcq_mm_fused uniform_mm ternary_mm] [--batches 1 4 64] [--out FILE]

Each ``--tree NAME=DIR`` names a directory holding ``src/repro_torch`` (for
example a ``git archive`` of another commit, unpacked under the gitignored
``build/``). The trees run in turns, forward then backward (``--rounds``
times each way), one process per turn, each building its own kernels. A
process times every kernel at each leaf it serves and each batch size:
calls cycling through rotated weight copies (so weights come from device
memory, not the 50 MB L2) are captured in a CUDA graph and its replays
timed with CUDA events, median of 7; the first call is held to the plain
version within 2e-4, unless ``--unchecked`` (for trees whose kernel had a
part taken out on purpose, to see what that part costs: their results
are wrong by design). It prints one line per turn, a table of medians with
each tree's decode step (each leaf once a layer, ``lm_head`` once, 28
layers), and with ``--out`` writes every run's times to that JSON file.
Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

LAYERS = 28
LEAVES = {  # llama3.2-3b: (k, o, fused out_dims or None)
    "wqkv": (3072, 5120, (3072, 1024, 1024)),
    "wo": (3072, 3072, None),
    "w_gate_up": (3072, 16384, (8192, 8192)),
    "w_down": (8192, 3072, None),
    "lm_head": (3072, 128256, None),
}
SERVES = {  # kernel: (format, leaves)
    "bcq_mm": ("bcq", ("wo", "w_down", "lm_head")),
    "bcq_mm_fused": ("bcq", ("wqkv", "w_gate_up")),
    "uniform_mm": ("uniform", tuple(LEAVES)),
    "ternary_mm": ("ternary", tuple(LEAVES)),  # bf16 x and alpha: the tensor-core path
}
L2_BYTES = 50 * 2**20
TOL = 2e-4


def child(kernels, batches, checked=True) -> None:
    import torch

    from repro_torch import kernels as K
    from repro_torch.core.formats import get_format

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, g = 4, 128

    def timed(fn, args_list, inner=None, reps=7):
        inner = inner or max(len(args_list), 5)
        for a in args_list[:3]:
            fn(*a)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(inner):
                fn(*args_list[i % len(args_list)])
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / inner)
        return statistics.median(times)

    out = {}
    for name in kernels:
        fmt, leaves = SERVES[name]
        f = get_format(fmt)
        fn = getattr(K, name)
        plain = getattr(K, f"{name.replace('_fused', '')}_plain")
        for leaf in leaves:
            k, o, dims = LEAVES[leaf]
            nbytes = f.planes(q) * k // 8 * o
            weights = []
            for _ in range(max(1, min(32, math.ceil(2.5 * L2_BYTES / nbytes)))):
                packed = torch.randint(0, 256, (f.planes(q), k // 8, o), generator=gen, device="cuda",
                                       dtype=torch.uint8)
                scales = (torch.rand(f.scales_shape(q, k // g, o), generator=gen, device="cuda") + 0.5) / k
                weights.append((packed, scales.to(torch.bfloat16)))
            for B in batches:
                x = torch.randn((B, k), generator=gen, device="cuda").to(torch.bfloat16)
                if name == "bcq_mm_fused":
                    call = lambda p, s: fn(x, p, s, g=g, out_dims=dims)  # noqa: E731
                    y = torch.cat(call(*weights[0]), dim=-1)
                else:
                    call = lambda p, s: fn(x, p, s, g=g)  # noqa: E731
                    y = call(*weights[0])
                err = (y - plain(x, *weights[0], g=g)).abs().max().item()
                if checked and not err <= TOL:
                    raise SystemExit(f"kernel_ab: {name} {leaf} B={B} differs from its plain version by {err}")
                out[f"{name} {leaf} {B}"] = timed(call, weights)
            del weights
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR, a tree holding src/repro_torch")
    ap.add_argument("--kernels", nargs="+", default=list(SERVES), choices=list(SERVES))
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 64])
    ap.add_argument("--rounds", type=int, default=1, help="forward-and-backward passes over the trees")
    ap.add_argument("--out", type=Path, help="a JSON file for every run's times")
    ap.add_argument("--unchecked", action="store_true", help="time without holding the first call to the plain version")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.kernels, args.batches, checked=not args.unchecked)
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
        cmd = [sys.executable, __file__, "--child", "--kernels", *args.kernels,
               "--batches", *map(str, args.batches)] + (["--unchecked"] if args.unchecked else [])
        res = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"kernel_ab: tree {name} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, "ms": got})
        print(f"  {name:10s} " + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in got.items()), flush=True)
    medians = {name: {key: statistics.median(r["ms"][key] for r in runs if r["tree"] == name)
                      for key in runs[0]["ms"]} for name, _ in trees}
    every = {"wqkv": LAYERS, "wo": LAYERS, "w_gate_up": LAYERS, "w_down": LAYERS, "lm_head": 1}
    for key in runs[0]["ms"]:
        print(f"{key:28s} " + "  ".join(f"{name} {medians[name][key] * 1e3:9.2f} us" for name, _ in trees))
    for kernel in args.kernels:
        for B in args.batches:
            steps = {name: sum(ms * every[key.split()[1]] for key, ms in medians[name].items()
                               if key.startswith(f"{kernel} ") and key.endswith(f" {B}")) for name, _ in trees}
            print(f"{kernel} step B={B}: " + "  ".join(f"{name} {ms:.3f} ms" for name, ms in steps.items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs, "medians": medians}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
