#!/usr/bin/env python3
"""How far recurrentgemma-9b's bf16 logits sit from each other and from the
f32-weight oracle, on one CUDA GPU (the measurement behind the smoke's
adjudicated logits check, ``chip_smoke.py::hybrid_logits_check``).

    python3 tools/hybrid_logits_probe.py

The model is the smoke's phase 12 model: full width, 38 layers, random
weights from seed 0, bcq (q = 4, g = 128, iters = 4) quantized on the card.
For prompts of 16, 512 and 3000 tokens it generates 8 tokens, feeds them
back one decode step at a time (teacher forcing) on the kernels and under
``impl_mode("ref")``, then in an f32 model of the same packed weights
dequantized to f32 (column blocks of 16384, so the 256000-wide ``lm_head``
fits) under ``impl_mode("ref")``, the oracle; it prints, per step,
max|d| / max|.| of kernel against ref, kernel against the oracle and ref
against the oracle, and the top-1 agreement with the oracle.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LENS = (16, 512, 3000)
FORCED = 8
COLS = 16384


def main() -> int:
    if not torch.cuda.is_available():
        print("hybrid_logits_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.infer import Engine
    from repro_torch.models import init_params
    from repro_torch.utils import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("recurrentgemma-9b")
    params = init_params(cfg, seed=0, device="cuda")
    engine = cs.quantized_engine(cfg, params, "bcq", max(PROMPT_LENS) + 100)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(12)
    prompts = {n: rng.integers(0, cfg.vocab, n).astype(np.int32) for n in PROMPT_LENS}
    forced, got = {}, {}
    for n, p in prompts.items():
        forced[n] = engine.generate(p[None], FORCED).tokens[0, n:]
        got[n] = {mode or "kernel": cs.forced_logits(engine, p, forced[n], mode).cpu() for mode in (None, "ref")}

    def to_f32(leaf):
        if not isinstance(leaf, QuantizedTensor):
            return leaf.to(torch.float32)
        f = get_format(leaf.fmt)
        layers = ([leaf] if leaf.packed.dim() == 3 else
                  [leaf.replace(packed=leaf.packed[i], scales=leaf.scales[i]) for i in range(leaf.packed.shape[0])])
        out = []
        for lf in layers:
            cols = [f.dequantize(lf.replace(packed=lf.packed[..., c : c + COLS].contiguous(),
                                            scales=lf.scales[..., c : c + COLS].contiguous(),
                                            o=min(COLS, lf.o - c)), dtype=torch.float32)
                    for c in range(0, lf.o, COLS)]
            out.append(torch.cat(cols, dim=-1))
        return out[0] if leaf.packed.dim() == 3 else torch.stack(out)

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(to_f32, engine.params)
    max_seq = engine.max_seq
    del engine
    torch.cuda.empty_cache()
    oracle = Engine(cfg32, p32, max_seq=max_seq, fuse=False, device="cuda")
    del p32

    def rel(a, b):
        return np.round(((a - b).abs().max(dim=-1).values / b.abs().max()).tolist(), 4).tolist()

    for n, p in prompts.items():
        f = cs.forced_logits(oracle, p, forced[n], "ref").cpu()
        k, r = got[n]["kernel"], got[n]["ref"]
        print(f"prompt {n}: per step max|d|/max|.|  kernel-ref {rel(k, r)}")
        print(f"   kernel-f32 {rel(k, f)}")
        print(f"   ref-f32    {rel(r, f)}")
        print(f"   top-1 agreement with the oracle: kernel {(k.argmax(-1) == f.argmax(-1)).float().mean().item()}, "
              f"ref {(r.argmax(-1) == f.argmax(-1)).float().mean().item()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
