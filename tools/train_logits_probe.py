#!/usr/bin/env python3
"""Where a trained llama3.2-3b's bf16 kernel-path logits leave the bf16 ref
path's, kernel by kernel, on one CUDA GPU (the measurement behind ROADMAP's
watch item on the trained model's logits).

    python3 tools/train_logits_probe.py [--steps 12]

The model is ``chip_smoke.py``'s phase 17 model: llama3.2-3b at full width
and depth, bf16, ``init_params(cfg, seed=0)``, trained ``--steps`` steps of
4 x 256 ``MarkovCorpus`` tokens through ``launch/train.py --full-size``,
then quantized to bcq (q = 4, g = 128, iters = 4) on the card. On the
smoke's prompts (prefill + 1 decode step of 4 x 16 tokens) it prints
max|d| / max|ref| of: the kernel path (K1/K2 and K8) against the ref path;
K1/K2 with K8 swapped for its plain version against the ref path; and the
kernel path against that swap (K8's share). It also prints the smoke's
adjudicated check (the kernel and ref paths against the f32-weight oracle)
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12, help="full-width train steps before quantizing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_logits_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.data import MarkovCorpus
    from repro_torch.infer import Engine
    from repro_torch.kernels import flash_attention_plain
    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cs.TRAIN_STEPS = args.steps
    cfg, params, _ = cs.train_full_width()
    engine = Engine(cfg, cs.quantize_format(cfg, params, "bcq"), max_seq=cs.PROMPT_LEN + cs.TRAIN_NEW + 8,
                    device="cuda")
    del params
    torch.cuda.empty_cache()
    corpus = MarkovCorpus(cfg.vocab, seed=0)
    prompts = torch.from_numpy(corpus.sample(cs.PROMPTS, cs.PROMPT_LEN, seed=cs.TRAIN_NLL_SEED + 1)[:, :cs.PROMPT_LEN])
    prompts = prompts.to(cs.DEVICE)
    run = lambda eng, mode: cs.family_step_logits(eng, prompts, None, mode)  # noqa: E731
    oracle = cs.xlstm_logits_check(engine, f"trained {args.steps} steps, prefill + 1 step", run)

    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    both, ref = run(engine, None), run(engine, "ref")
    real, layers.flash_attention = layers.flash_attention, flash_attention_plain
    try:
        k12 = run(engine, None)
    finally:
        layers.flash_attention = real
    d = dict(k1k2_k8_vs_ref=rel(both, ref), k1k2_vs_ref=rel(k12, ref), k8_share=rel(both, k12))
    print(f"bf16 logits by kernel, max|d| / max|ref| ({args.steps} steps): K1/K2 + K8 vs ref "
          f"{d['k1k2_k8_vs_ref']:.3e}; K1/K2 with plain attention vs ref {d['k1k2_vs_ref']:.3e}; K8 against plain "
          f"attention, both on K1/K2, {d['k8_share']:.3e}", flush=True)
    print(json.dumps({"card": card, "steps": args.steps, "by_kernel": d, "oracle": oracle}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
