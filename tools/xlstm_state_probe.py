#!/usr/bin/env python3
"""Peak device memory of a committing prefill of xlstm-125m: the recurrent
state collected after every prompt token (``forward(collect_states=True)``,
the reference's per-token stacks) against after the prefix cache's block
boundaries and the last token only (``collect_states=steps``, what
``Engine`` asks for).

    python3 tools/xlstm_state_probe.py [--lens 512 3000] [--block 16]

Needs one CUDA GPU. Full-width xlstm-125m (12 layers), random weights from
seed 0, bcq q = 4, g = 128 quantized on the card. An mLSTM layer's state is
a (4, 384, 384) f32 matrix memory a row, 14.2 MB over the model's 6 mLSTM
layers: a per-token stack of a long prompt does not fit. Prints one line a
(length, collection) and writes ``chiprun_out/xlstm_state_probe.json``; a
collection that runs out of memory is reported as such.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lens", type=int, nargs="+", default=[512, 3000])
    ap.add_argument("--block", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xlstm_state_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import forward, init_params
    from repro_torch.quant import QuantPolicy, quantize_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = get_config("xlstm-125m")
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), QuantPolicy(q=4, g=128, iters=4),
                             device="cuda")
    engine = Engine(cfg, params, max_seq=max(args.lens) + 8, device="cuda")
    del params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = []
    for n in args.lens:
        tokens = torch.randint(0, cfg.vocab, (1, n), generator=gen, device="cuda")
        steps = tuple(sorted({e - 1 for e in range(args.block, n + 1, args.block)} | {n - 1}))
        for label, collect in (("every token", True), ("block boundaries", steps)):
            cache = engine._make_cache(1)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kept = n if collect is True else len(steps)
            rec = dict(prompt=n, collect=label, states_kept=kept)
            try:
                t0 = time.perf_counter()
                with torch.no_grad():
                    _, tree = forward(cfg, engine.params, tokens=tokens, cache=cache, pos=0, logits_mode="last",
                                      prefill=True, collect_states=collect)
                torch.cuda.synchronize()
                rec.update(ok=True, s=time.perf_counter() - t0,
                           stacks_gb=sum(leaf.numel() * leaf.element_size()
                                         for stage in tree["stages"] for blk in stage.values()
                                         for leaf in blk.values()) / 1e9)
                del tree
            except torch.cuda.OutOfMemoryError as e:
                rec.update(ok=False, error=str(e).splitlines()[0])
            rec["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            del cache
            out.append(rec)
            what = (f"{rec['s']:.3f} s, the collected tree {rec['stacks_gb']:.3f} GB" if rec["ok"]
                    else f"out of memory ({rec['error'][:90]})")
            print(f"[xlstm state] {n}-token committing prefill, state kept after {label} ({kept} steps): peak "
                  f"{rec['peak_gb']:.3f} GB above the resident {base / 1e9:.3f} GB; {what}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "xlstm_state_probe.json").write_text(json.dumps({"card": card, "runs": out}, indent=1))
    print(json.dumps({"card": card, "runs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
