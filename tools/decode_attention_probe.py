#!/usr/bin/env python3
"""Whether the decode attention gives a batch row the bits of the row alone,
and what that costs, on one CUDA GPU.

    python3 tools/decode_attention_probe.py

For llama3.2-3b's heads (24 / 8, Dh 128) and recurrentgemma-9b's (16 / 1,
Dh 256) over caches of 536..3040 rows (bf16, random), 64 query rows are
attended alone and in calls of N rows; it prints, for each variant, how many
of the N rows differ from the row alone, its time at one width (CUDA events,
median of 5) and its largest difference from the plain variant:

- ``plain``: the products summed with torch's ``sum`` over the last axis
  (``models/layers.py::_sdpa_decode`` before the row-invariant sums);
- ``row_sum``: both sums in ``utils.row_sum``'s 32-wide stages, V copied
  to put S_max last;
- ``col``: the logits' sum as ``row_sum``, the values' product laid out
  (S_max, Dh) and summed over S_max in 32-row column stages;
- ``kept``: ``layers._sdpa_decode`` as the port runs it.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CASES = ((16, 1, 256, 2048, 4), (24, 8, 128, 2048, 4), (24, 8, 128, 2048, 64), (16, 1, 256, 3040, 4),
         (24, 8, 128, 536, 16))  # (H, Hkv, Dh, S_max, B timed)


def variants():
    from repro_torch.models.layers import NEG_INF, _sdpa_decode
    from repro_torch.utils import row_sum

    def logits_probs(q, ck, cv, mask, staged):
        b, _, h, dh = q.shape
        hkv = ck.shape[2]
        qg = q.reshape(b, hkv, h // hkv, 1, dh).to(torch.float32)
        prod = qg * ck.permute(0, 2, 1, 3)[:, :, None]
        logits = (row_sum(prod)[..., 0] if staged else prod.sum(-1)) / math.sqrt(dh)
        logits = torch.where(mask, logits, NEG_INF)
        return torch.softmax(logits, dim=-1).to(cv.dtype).to(torch.float32)

    def plain(q, ck, cv, mask):
        b, _, h, dh = q.shape
        probs = logits_probs(q, ck, cv, mask, False)
        vals = cv.permute(0, 2, 3, 1)[:, :, None]
        return (probs[:, :, :, None, :] * vals).sum(-1).reshape(b, 1, h, dh).to(q.dtype)

    def staged_rows(q, ck, cv, mask):
        b, _, h, dh = q.shape
        probs = logits_probs(q, ck, cv, mask, True)
        vals = cv.permute(0, 2, 3, 1).contiguous()[:, :, None]
        return row_sum(probs[:, :, :, None, :] * vals)[..., 0].reshape(b, 1, h, dh).to(q.dtype)

    def col(q, ck, cv, mask):
        b, _, h, dh = q.shape
        probs = logits_probs(q, ck, cv, mask, True)
        part = probs[..., None] * cv.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, G, S, Dh)
        while part.shape[-2] > 32:
            pad = -part.shape[-2] % 32
            if pad:
                part = torch.nn.functional.pad(part, (0, 0, 0, pad))
            part = part.reshape(*part.shape[:3], -1, 32, dh).sum(-2)
        return part.sum(-2).reshape(b, 1, h, dh).to(q.dtype)

    return {"plain": plain, "row_sum": staged_rows, "col": col, "kept": _sdpa_decode}


def median_ms(fn, *args):
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_attention_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    fns = variants()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for H, Hkv, Dh, S, B in CASES:
        q = torch.randn((64, 1, H, Dh), generator=gen, device="cuda").bfloat16()
        ck = torch.randn((64, S, Hkv, Dh), generator=gen, device="cuda").bfloat16()
        cv = torch.randn((64, S, Hkv, Dh), generator=gen, device="cuda").bfloat16()
        pos = torch.randint(S // 2, S, (64,), generator=gen, device="cuda")
        mask = (torch.arange(S, device="cuda")[None] <= pos[:, None])[:, None, None, :]
        ref = fns["plain"](q[:B], ck[:B], cv[:B], mask[:B]).float()
        for name, fn in fns.items():
            alone = torch.cat([fn(q[i : i + 1], ck[i : i + 1], cv[i : i + 1], mask[i : i + 1]) for i in range(64)])
            differ = {n: int((fn(q[:n], ck[:n], cv[:n], mask[:n]) != alone[:n]).reshape(n, -1).any(-1).sum())
                      for n in (2, 4, 8, 16, 64)}
            ms = median_ms(fn, q[:B], ck[:B], cv[:B], mask[:B])
            dev = (fn(q[:B], ck[:B], cv[:B], mask[:B]).float() - ref).abs().max().item()
            print(f"H {H}/{Hkv} Dh {Dh} S_max {S} B {B} {name:8s}: {ms:.3f} ms; rows != alone by N {differ}; "
                  f"max|d| from plain {dev:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
