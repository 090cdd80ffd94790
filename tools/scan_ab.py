#!/usr/bin/env python3
"""Device times and output bits of the scan kernels, K9 ``rglru_scan``, K10
``mlstm_scan`` and K11 ``slstm_scan``, for several source trees of the port
in turns, inside one run.

    python3 tools/scan_ab.py --tree parent=DIR --tree change=. [--kernels K9 K10 K11] \\
        [--rounds 1] [--step] [--out FILE]

Each ``--tree NAME=DIR`` names a directory holding ``src/repro_torch`` (for
example a ``git archive`` of another commit, unpacked under the gitignored
``build/``). The trees run in turns, forward then backward (``--rounds``
times each way), one process per turn, each building its own kernels. A
process runs every kernel at ``chip_smoke.py``'s shapes (K9: ``K9_SHAPES``
at recurrentgemma-9b's W = 4096; K10 and K11: ``XLSTM_SCAN_SHAPES`` at
xlstm-125m's heads, mLSTM Dh 384, sLSTM Dh 192 with R in bf16), plus ragged
and misaligned ones, from inputs made from one seed on the card: it hashes
every output (h or hs, the final state written in place, and the states kept
at steps {0, S/2, S-1}) and times the call without ``steps`` by CUDA-graph
replay (20 calls a graph, so a decode launch of a few µs is not lost in
the events' resolution; median of 7 replays). At the decode and verify
shapes (S <= 20) it also reads each kernel's own device time from a
``torch.profiler`` trace of a replay, hot (the calls back to back, so C and
the inputs sit in L2) and cold (each call after a read of 128 MB, 2.5x the
L2, as in a model's step, where the weights pass through L2 between two
launches of a layer's scan): keys ``... kernel hot`` and ``... kernel
cold``, medians over the launches. ``--step`` also traces xlstm-125m's
batched ``generate`` (4 prompts of 16 tokens, 32 new, bcq q = 4 g = 128,
random weights from seed 0, the decode step a replayed CUDA graph, as
``chip_smoke.py`` phase 13 runs it): K10's and K11's own time a launch at
the prefill (S = 16) and at decode, the idle time before and after each
decode launch of K10, and the device time a forward (``--kernels`` may
then be empty). Every library a tree needs is built first, the trees'
builds side by side. The first tree's hashes are the reference: every
other tree's outputs must match them bit for bit, or the run exits 1
(``--unchecked`` only reports, for trees with a part taken out on
purpose). It prints the card, one line per turn, then a table of medians.
Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

W9 = 4096  # recurrentgemma-9b's lru_width
K9_SHAPES = ((1, 3000), (4, 1), (64, 1), (4, 20))  # chip_smoke.py::K9_SHAPES
K9_EXTRA = ((2, 1031, 4096), (3, 7, 300), (2, 513, 1000), (2, 100, 257),  # (B, S, W): ragged, misaligned
            (1, 32, 4096), (1, 33, 4096), (4, 64, 4096))  # one ring stage, and past it
NH, DH10, DH11 = 4, 384, 192  # xlstm-125m's heads
XLSTM_SCAN_SHAPES = ((4, 1), (4, 5), (1, 3000), (64, 1))  # chip_smoke.py::XLSTM_SCAN_SHAPES
K10_EXTRA = ((1, 257, 4, 384), (2, 7, 4, 30), (3, 9, 2, 100), (2, 40, 4, 32))  # (B, S, NH, Dh)
K11_EXTRA = ((3, 9, 2, 100),)
DECODE_S = 20  # shapes up to this S also get their kernel's own time, hot and cold
FLUSH_BYTES = 128 << 20  # 2.5x the H100's 50 MB L2
LIBS = {"K9": ["rglru_scan"], "K10": ["mlstm_scan"], "K11": ["slstm_scan"], "step": ["bcq_mm", "mlstm_scan", "slstm_scan"]}


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:20]


def kernel_ms(events, tag):
    """Durations (ms) of a trace's device events whose name holds ``tag``."""
    from torch.autograd import DeviceType

    return [ev.duration_ns() / 1e6 for ev in events if ev.device_type() == DeviceType.CUDA and tag in ev.name()]


def trace(run):
    """The device events of ``run()`` under ``torch.profiler``, by start."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((ev for ev in prof.profiler.kineto_results.events() if ev.device_type() == DeviceType.CUDA),
                  key=lambda ev: ev.start_ns())


def xlstm_step(new=32):
    """xlstm-125m's batched ``generate`` (``chip_smoke.py`` phase 13's main
    path), traced: K10's and K11's time a launch at the prefill and at
    decode, the idle time around K10's decode launches, and the device time
    a forward."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import init_params
    from repro_torch.quant import QuantPolicy, quantize_params

    cfg = get_config("xlstm-125m")
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), QuantPolicy(q=4, g=128, iters=4, fmt="bcq"),
                             device="cuda")
    engine = Engine(cfg, params, max_seq=3000 + new + 8, device="cuda")
    prompts = np.random.default_rng(13).integers(0, cfg.vocab, (4, 16))
    engine.generate(prompts, 2)  # the graph's warm-up and capture
    engine.generate(prompts, new)
    events = trace(lambda: engine.generate(prompts, new))
    n = cfg.block_counts()
    out = {}
    for name, tag, cells in (("K10", "mlstm_scan", n["mlstm"]), ("K11", "slstm_scan", n["slstm"])):
        at = [i for i, ev in enumerate(events) if tag in ev.name()]
        if len(at) != cells * (1 + new):
            raise SystemExit(f"scan_ab: the trace holds {len(at)} {name} launches, not {cells * (1 + new)}")
        durs = [events[i].duration_ns() / 1e6 for i in at]
        out[f"step {name} prefill (4, 16)"] = statistics.mean(durs[:cells])
        out[f"step {name} decode (4, 1)"] = statistics.median(durs[cells:])
        if name == "K10":
            dec = [i for i in at[cells:] if 0 < i < len(events) - 1]
            out["step K10 idle before"] = statistics.median(
                (events[i].start_ns() - events[i - 1].end_ns()) / 1e6 for i in dec)
            out["step K10 idle after"] = statistics.median(
                (events[i + 1].start_ns() - events[i].end_ns()) / 1e6 for i in dec)
    out["step device a forward"] = sum(ev.duration_ns() for ev in events) / 1e6 / (1 + new)
    return out


def child(kernels, step) -> None:
    import torch

    from repro_torch.kernels import mlstm_scan, rglru_scan, slstm_scan
    from repro_torch.kernels.mlstm_scan import scale_for

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    junk, sink = torch.ones(FLUSH_BYTES // 4, device=dev), torch.zeros((), device=dev)

    def timed(fn, reps=7, inner=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
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

    def own(key, tag, fn, S, reps=3, inner=10):
        """The kernel's own device time a launch, hot and cold (module docstring)."""
        if S > DECODE_S:
            return
        for name, body in (("hot", fn), ("cold", lambda: (torch.sum(junk, 0, out=sink), fn()))):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(inner):
                    body()
            graph.replay()
            ms[f"{key} kernel {name}"] = statistics.median(kernel_ms(trace(lambda: [graph.replay() for _ in range(reps)]),
                                                                     tag))

    ms, bits = {}, {}
    if "K9" in kernels:
        for B, S, W in [(B, S, W9) for B, S in K9_SHAPES] + list(K9_EXTRA):
            gen.manual_seed(B * 31 + S + W)
            a = torch.rand((B, S, W), generator=gen, device=dev) * 0.2 + 0.8
            g = torch.randn((B, S, W), generator=gen, device=dev) * 0.1
            h0 = torch.randn((B, W), generator=gen, device=dev)
            key = f"K9 ({B}, {S}) W={W}"
            bits[key] = digest(*rglru_scan(a, g, h0))
            ms[key] = timed(lambda: rglru_scan(a, g, h0))
            own(key, "rglru_scan", lambda: rglru_scan(a, g, h0), S if W == W9 else DECODE_S + 1)
    if "K10" in kernels:
        for B, S, nh, dh in [(B, S, NH, DH10) for B, S in XLSTM_SCAN_SHAPES] + list(K10_EXTRA):
            gen.manual_seed(B * 131 + S + dh)
            xs = [torch.randn((B, S, nh, dh), generator=gen, device=dev) for _ in range(3)]
            xs += [torch.randn((B, S, nh), generator=gen, device=dev),
                   torch.nn.functional.logsigmoid(torch.randn((B, S, nh), generator=gen, device=dev) + 2.0)]
            state = [torch.randn((B, nh, dh, dh), generator=gen, device=dev) * 0.1,
                     torch.randn((B, nh, dh), generator=gen, device=dev), torch.randn((B, nh), generator=gen, device=dev)]
            sc, steps = scale_for(dh), sorted({0, S // 2, S - 1})
            key = f"K10 ({B}, {S}) NH={nh} Dh={dh}"
            st = [t.clone() for t in state]
            h, _ = mlstm_scan(*xs, *st, sc)
            _, stacks = mlstm_scan(*xs, *[t.clone() for t in state], sc, steps=steps)
            bits[key] = digest(h, *st, *(stacks[n] for n in "cnm"))
            ms[key] = timed(lambda: mlstm_scan(*xs, *st, sc))
            own(key, "mlstm_scan", lambda: mlstm_scan(*xs, *st, sc), S if dh == DH10 else DECODE_S + 1)
    if "K11" in kernels:
        for B, S, nh, dh in [(B, S, NH, DH11) for B, S in XLSTM_SCAN_SHAPES] + list(K11_EXTRA):
            gen.manual_seed(B * 17 + S + dh)
            pre = [torch.randn((B, S, nh, dh), generator=gen, device=dev) for _ in range(4)]
            r = [(torch.randn((nh, dh, dh), generator=gen, device=dev) / dh**0.5).to(torch.bfloat16) for _ in range(4)]
            state = [torch.randn((B, nh, dh), generator=gen, device=dev) for _ in range(4)]
            state[2] = state[2].abs() + 0.5
            steps = sorted({0, S // 2, S - 1})
            key = f"K11 ({B}, {S}) NH={nh} Dh={dh}"
            st = [t.clone() for t in state]
            hs, _ = slstm_scan(pre, r, st)
            _, stacks = slstm_scan(pre, r, [t.clone() for t in state], steps=steps)
            bits[key] = digest(hs, *st, *(stacks[n] for n in "hcnm"))
            ms[key] = timed(lambda: slstm_scan(pre, r, st))
            own(key, "slstm_scan", lambda: slstm_scan(pre, r, st), S if dh == DH11 else DECODE_S + 1)
    if step:
        ms.update(xlstm_step())
    print(json.dumps({"ms": ms, "bits": bits}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR, a tree holding src/repro_torch")
    ap.add_argument("--kernels", nargs="*", default=["K9", "K10", "K11"], choices=["K9", "K10", "K11"])
    ap.add_argument("--step", action="store_true", help="also trace xlstm-125m's batched generate")
    ap.add_argument("--rounds", type=int, default=1, help="forward-and-backward passes over the trees")
    ap.add_argument("--out", type=Path, help="a JSON file for every run's times and hashes")
    ap.add_argument("--unchecked", action="store_true", help="report differing bits without failing")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.kernels, args.step)
        return 0
    if not args.tree:
        ap.error("name at least one --tree")
    trees = [t.split("=", 1) for t in args.tree]
    order = (trees + trees[::-1]) * args.rounds
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = sorted({lib for k in [*args.kernels, *(["step"] if args.step else [])] for lib in LIBS[k]})
    builds = [subprocess.Popen([sys.executable, "-c", f"from repro_torch.kernels import _build; _build.build({libs!r})"],
                               env=dict(os.environ, PYTHONPATH=str((Path(d) / "src").resolve())))
              for _, d in trees]
    if any(b.wait() for b in builds):
        raise SystemExit("scan_ab: a tree's kernels did not build")
    runs = []
    for name, d in order:
        env = dict(os.environ, PYTHONPATH=str((Path(d) / "src").resolve()))
        res = subprocess.run([sys.executable, __file__, "--child", "--kernels", *args.kernels,
                              *(["--step"] if args.step else [])], env=env, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"scan_ab: tree {name} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, **got})
        print(f"  {name:10s} " + ", ".join(f"{key} {v * 1e3:.2f} us" for key, v in got["ms"].items()), flush=True)
    ref = runs[0]["bits"]
    differ = sorted({(r["tree"], key) for r in runs for key, h in r["bits"].items() if h != ref.get(key)})
    medians = {name: {key: statistics.median(r["ms"][key] for r in runs if r["tree"] == name)
                      for key in runs[0]["ms"]} for name, _ in trees}
    first = trees[0][0]
    for key in runs[0]["ms"]:
        same = all((name, key) not in differ for name, _ in trees)
        print(f"{key:42s} " + "  ".join(f"{name} {medians[name][key] * 1e3:10.2f} us" for name, _ in trees)
              + "".join(f"  {name}/{first} {medians[name][key] / medians[first][key]:.3f}x" for name, _ in trees[1:])
              + ("" if key not in runs[0]["bits"] else "  bits equal" if same else "  BITS DIFFER"))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs, "medians": medians,
                                        "differ": differ}, indent=1))
    print(f"bits: {'every output of every tree equals ' + first + chr(39) + 's' if not differ else differ}")
    return 1 if differ and not args.unchecked else 0


if __name__ == "__main__":
    sys.exit(main())
