#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py    # full llama3.2-3b, all 28 layers, every format

Phases, each printed on lines of its own; any failure raises and the exit
code is non-zero:

1. card      the ``nvidia-smi`` name and power limit line;
2. build     nvcc builds every kernel from ``src/repro_torch/csrc``, all
             sources at once (timed);
3. kernels   each of the seven quantized-matmul kernels against its plain
             PyTorch version at the main path's leaf shapes (B = 1, 4 and the
             prefill row count) and the reference's kernel sweep, with bf16
             and f32 inputs (``ternary_mm`` also with bf16 x and f32 scales
             and the reverse: bf16/bf16 takes its tensor cores, the other
             three its group-table kernel): max error against the tolerance
             (2e-4 for all: kernel and plain version widen the same inputs
             to f32 and differ only in summation order), the same bits on a
             rerun, kernel time, plain time, the byte /
             operation bound (the format's own planes, scales, x and output)
             and ``library_ms`` (``torch.matmul`` of bf16 x against the
             pre-dequantized bf16 weight, the paper's cuBLAS baseline, timed
             here only). ``dequant_materialize`` is held to its plain version
             bit for bit, and its pipeline ``dequant_mm`` (materialise, then
             an f32 GEMM) is checked and timed beside it, GEMM alone too.
             The bf16 leaf times of ``codebook_mm``, ``lutgemm``, ``bcq_mm``,
             ``bcq_mm_fused``, ``uniform_mm`` and ``ternary_mm`` are also
             printed as multiples of their bounds and of the library call,
             with the decode steps of K3, of the bcq path (K1 + K2), of K5
             and of K4 at B = 1, 4 and 64 beside the library's (the paper's
             Table 3 comparison). Each row of a 16-row call of K3, K1, K2,
             K5 and K4 at ``wo`` must equal the row called alone, bit for
             bit, as must each row of a K1 and a K4 call 8 rows wider than
             its row slab, in bf16 and f32 (K4: both paths). K1 and K5 at
             ``wo`` for q = 1..8, and K4's group-table path, on the table
             path and the direct path (both checked, both timed) give the
             measurement behind ``grouptable.TABLE_MAX_Q``. Last, the dense
             check (asserted): dense bf16 (``utils.matmul_rows``) and
             ``dequant_mm`` products of 4, 9, 16 and 64 decode rows at
             ``wo`` and ``w_gate_up`` must give each row the bits of the row
             alone (fixed tiles of rows, so cuBLAS sees one shape), and what
             the tiles cost a B = 4 decode step against one product. The
             speculative path's shapes (bf16): K1/K2 and K3 at q' = 1 and 2
             planes on the five leaves at B = 1, 4, the verify's 4·(γ+1) =
             20 rows and the draft prefill's 64, at q = 4 at 20 rows, and K4
             at 20 rows, each checked and timed with its byte bound; K1/K2
             at q' = 2 and q = 4 at phase 6's prompt lengths, checked; and
             each path's decode step at every q and B;
4. flash     ``flash_attention`` (K8) against its plain version (``_sdpa``
             under a causal mask, run one batch row at a time) at
             llama3.2-3b's heads (24 / 8, Dh 128) for B in {1, 4} and S in
             {1, 16, 17, 100, 512, 2048, 8192}, at the reference test's four
             shapes and at Dh 16 and 64, in bf16 (rtol = atol = 3e-2) and f32
             (2e-4), the reference test's own ``assert_allclose``, and in bf16 also
             per query row: max|Δ| over the row's Dh values within 2^-6 of
             the row's max|plain| (``BF16_ROW_TOL``: twice one bf16 ulp of
             the output; the long rows' values fall as 1/sqrt(S), below the
             absolute limit); a rerun must give the same bits. Timed like the other kernels, beside
             ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
             on the same bf16 inputs (the library yardstick, never on a path),
             each with its achieved TFLOP/s (the causal pairs' operations over
             its time). bf16 runs on the tensor cores, f32 on the CUDA cores;
5. main path full-width llama3.2-3b with random weights from a seed, once
             per format, each quantized on the card (q=4, g=128, iters=4)
             and served by an ``Engine`` with fused QKV / gate-up:
             - ``bcq``: ``generate`` for 4 prompts batched, once per request
               as ``--sequential`` serves them, and batched again with every
               quantized linear on the paper's LUT kernel;
             - ``uniform``, ``dequant``, ``ternary``, ``codebook``:
               ``generate`` batched; every ternary linear of the bf16 model
               must take K4's tensor-core path.
             Every prefill's attention runs on K8. Launch counts are set to
             0 just before each path's run and read just after; each path
             must launch its kernels the expected number of times and take
             the ref oracle never. Each path's logits are then held against
             the same engine under ``impl_mode("ref")``, and a reduced f32
             model per format against its oracle within the kernels'
             tolerance;
6. serving   the continuous-batching path on the bcq model: 12 requests of
             16 new tokens, prompts of 16 to 512 tokens (so K8 sees ragged
             S), greedy and sampled, through 4 slots with chunk 8. Every
             admission prefills through K8; greedy completions must equal a
             solo ``generate`` of each request, with the largest logit
             difference between a slot batch and solo forwards reported;
             tok/s, TTFT p50/p95 and the device's busy share are reported.
             Then one request of ``LONG_SEQ_THRESHOLD`` = 8192 prompt tokens
             and 8 new tokens through the scheduler: its prefill time and
             peak device memory above the resident weights and cache, against
             the ~6.4 GB of f32 logits per layer that ``_sdpa`` would need,
             and its greedy tokens against the same request under
             ``impl_mode("ref")`` (``_sdpa_qchunked`` at this length);
7. spec      self-speculative decoding (``SpecConfig(2, 4)``; ternary
             ``(1, 4)``) at full width and depth: a batched ``generate`` (4
             prompts of 16 tokens, 16 new) on the bcq model, on it under
             ``impl_mode("lutgemm")`` and on the ternary model must give the
             plain greedy tokens; each run's launches, counted by (kernel,
             planes, rows) (``kernel_census``), must be what the chunk
             structure predicts (both prefills at q and q' planes, γ + 1 draft
             steps at q' planes and B rows, one verify at q planes and
             B·(γ+1) rows a chunk), K8 twice a layer, the ref oracle never,
             and every (kernel, planes, rows) launched must be one phase 3
             held to its plain version. A fourth run drafts with all q = 4
             planes (``SpecConfig(4, 4)``: the draft is the target) and must
             accept every proposal, so the verify's rows 1..γ, the
             multi-token commit and the draft cache's continuity are
             exercised at full depth. Then phase 6's 12 requests through a speculative 4-slot
             scheduler, the temperature-1.0 requests opted out: every greedy
             and opted-out request must equal its solo plain ``generate``,
             with the launches predicted the same way. Each run prints its
             acceptance, chunks, tok/s and TTFT beside the plain run's, and
             the device-busy share of a profiled second run; the device time
             of one draft step, one q = 4 step and one verify forward too;
8. one JSON line listing every kernel, its launches (``spec_launches``: on
             phase 7's runs) and its numbers;
9. last line ``{"ok": true, "device": {...}}``.

Timing: repeated calls after warm-up are captured in a CUDA graph and timed
with CUDA events around its replay (median of 7), so a time is the device's
and not the host's per-call cost. Weight copies
are rotated so that repeated launches read weights from device memory, not
from the 50 MB L2, as a decode step does. Phase 5 also traces one batched
``generate`` per format with ``torch.profiler`` for the device's busy time
by kernel, and reads each path's peak device memory.

It needs a CUDA GPU and the repository's ``src/`` beside it; without either
it exits non-zero before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = torch.device("cuda")

# H100 SXM data-sheet peaks (dense): HBM rate, f32 CUDA-core and bf16
# tensor-core rates
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs its plain version, rtol = atol, for f32 and bf16 inputs alike: both
# sides widen the same x and scales to f32 and accumulate in f32
KERNEL_TOL = 2e-4
LOGITS_REL_TOL = 3e-2  # engine vs ref oracle, bf16 model: max|Δ| / max|ref|

Q, G = 4, 128
PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 16, 16
# (leaf, k, o, fused out_dims or None) of llama3.2-3b
LEAVES = {
    "wqkv": (3072, 5120, (3072, 1024, 1024)),
    "wo": (3072, 3072, None),
    "w_gate_up": (3072, 16384, (8192, 8192)),
    "w_down": (8192, 3072, None),
    "lm_head": (3072, 128256, None),
}
SWEEP = [  # (B, k, o, q, g): the reference's kernel sweep
    (1, 512, 256, 2, 64),
    (8, 512, 128, 4, 512),
    (8, 1024, 256, 3, 128),
    (16, 512, 384, 1, 8),
    (4, 1024, 128, 5, 1024),
    (2, 2048, 256, 2, 2048),
]
# kernel: (CUDA source, replaced TPU kernel, leaves it serves, format)
KERNELS = {
    "bcq_mm": ("csrc/bcq_mm.cu", "src/repro/kernels/bcq_mm.py:138", ("wo", "w_down", "lm_head"), "bcq"),
    "bcq_mm_fused": ("csrc/bcq_mm.cu", "src/repro/kernels/bcq_mm_fused.py:63", ("wqkv", "w_gate_up"), "bcq"),
    "lutgemm": ("csrc/lutgemm.cu", "src/repro/kernels/lutgemm.py:149", tuple(LEAVES), "bcq"),
    "uniform_mm": ("csrc/uniform_mm.cu", "src/repro/kernels/uniform_mm.py:130", tuple(LEAVES), "uniform"),
    "dequant_materialize": ("csrc/dequant_mm.cu", "src/repro/kernels/dequant_mm.py:106", tuple(LEAVES),
                            "dequant"),
    "ternary_mm": ("csrc/ternary_mm.cu", "src/repro/kernels/ternary_mm.py:140", tuple(LEAVES), "ternary"),
    "codebook_mm": ("csrc/codebook_mm.cu", "src/repro/kernels/codebook_mm.py:145", tuple(LEAVES), "codebook"),
}
FLASH = ("flash_attention", "csrc/flash_attn.cu", "src/repro/kernels/flash_attn.py:109")
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}  # the reference test's tolerances
LLAMA_HEADS = (24, 8, 128)  # llama3.2-3b: H, Hkv, Dh
FLASH_S = (1, 16, 17, 100, 512, 2048, 8192)
FLASH_EXTRA = [  # (B, S, H, Hkv, Dh): the reference test's shapes, then Dh 16 and 64
    (2, 512, 4, 4, 64), (1, 1024, 8, 2, 32), (2, 512, 6, 1, 64), (1, 512, 2, 2, 128),
    (2, 300, 4, 2, 16), (1, 777, 8, 4, 64),
]
# the continuous-batching phase: prompt lengths over 16..512 (ragged for K8)
SERVE_PROMPT_LENS = (16, 512, 37, 200, 100, 17, 300, 64, 450, 129, 24, 256)
SERVE_SLOTS, SERVE_CHUNK = 4, 8
# self-speculative decoding (phase 7): q' draft planes, gamma proposals a chunk;
# a speculative dispatch of the scheduler runs SPEC_CHUNK chunks
SPEC_Q, SPEC_GAMMA, SPEC_Q_TERNARY = 2, 4, 1
SPEC_CHUNK = 2
VERIFY_ROWS = PROMPTS * (SPEC_GAMMA + 1)  # a batched generate's verify: B·(γ+1) rows
DRAFT_Q = (1, 2)
# the bcq model's leaves and the kernel each one launches (fused leaves: K2)
BCQ_LEAF_KERNELS = {"wqkv": "bcq_mm_fused", "wo": "bcq_mm", "w_gate_up": "bcq_mm_fused", "w_down": "bcq_mm",
                    "lm_head": "bcq_mm"}
LONG_NEW = 8
# the formats served after bcq, with the kernel each one's path launches
FORMAT_KERNEL = {"uniform": "uniform_mm", "dequant": "dequant_materialize", "ternary": "ternary_mm",
                 "codebook": "codebook_mm"}
# part of the device kernel names of each format's path (bcq: K1 and K2; ternary's
# bf16 model: K4's tensor-core kernel)
PROFILE_TAG = {"bcq": "BCQGroups", "uniform": "UniformGroups", "dequant": "dequant_kernel",
               "ternary": "ternary_tc_kernel", "codebook": "codebook_kernel"}
# the (x, scales) dtype pairs each kernel is checked at: K4 takes the tensor
# cores for bf16/bf16 and the group-table kernel for the other three
SAME_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32))
DTYPE_PAIRS = {"ternary_mm": SAME_DTYPES + ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))}
# part of K8's device kernel names: bf16 on the tensor cores, f32 on the CUDA cores
FLASH_TAGS = ("flash_tc_kernel", "flash_kernel")
L2_BYTES = 50 * 2**20


def log(*a):
    print(*a, flush=True)


def _calls(fn, args_list, inner):
    """Run ``inner`` calls of ``fn``, cycling through ``args_list``."""
    for i in range(inner):
        fn(*args_list[i % len(args_list)])


def _median_event_ms(run, inner, reps):
    """Median over ``reps`` of CUDA-event time around ``run()``, over ``inner``."""
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def time_ms(fn, args_list, *, reps=7, inner=None):
    """Time of one call of ``fn`` after warm-up, cycling through ``args_list``
    (rotated weight copies). ``inner`` calls are captured once in a CUDA graph
    and its replays are timed: the device's time, without the host's per-call
    cost (Python, ctypes, allocator), which at decode shapes can exceed the
    kernel's."""
    inner = inner or max(len(args_list), 5)
    _calls(fn, args_list[:3], min(3, len(args_list)))  # lazy attributes, library handles
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _calls(fn, args_list, inner)
    g.replay()
    torch.cuda.synchronize()
    return _median_event_ms(g.replay, inner, reps)


def n_copies(nbytes):
    return max(1, min(32, math.ceil(2.5 * L2_BYTES / max(nbytes, 1))))


def kernel_fns():
    """kernel name → (wrapper checked, plain version). ``dequant_materialize``
    is checked through its pipeline ``dequant_mm`` here and on its own in
    :func:`check_kernel`."""
    from repro_torch import kernels as K

    return {
        "bcq_mm": (K.bcq_mm, K.bcq_mm_plain),
        "bcq_mm_fused": (K.bcq_mm_fused, K.bcq_mm_plain),
        "lutgemm": (K.lutgemm, K.lutgemm_plain),
        "uniform_mm": (K.uniform_mm, K.uniform_mm_plain),
        "dequant_materialize": (K.dequant_mm, K.dequant_mm_plain),
        "ternary_mm": (K.ternary_mm, K.ternary_mm_plain),
        "codebook_mm": (K.codebook_mm, K.codebook_mm_plain),
    }


def format_planes(fmt, k, o, q, g, gen):
    """Random packed planes and f32 scales of ``fmt`` on the card, with
    weights of about 1/sqrt(k) (BCQ: its q planes sum to that)."""
    from repro_torch.core.formats import get_format

    f = get_format(fmt)
    dev = DEVICE
    packed = torch.randint(0, 256, (f.planes(q), k // 8, o), generator=gen, device=dev, dtype=torch.uint8)
    shape = f.scales_shape(q, k // g, o)
    u = (torch.rand(shape, generator=gen, device=dev) + 0.5) / math.sqrt(k)
    if fmt == "bcq":
        u = u / math.sqrt(q)
    elif fmt in ("uniform", "dequant"):  # (s, z): codes centred on 0
        s = u[0] / 2**q
        u = torch.stack([s, -s * (2**q - 1) / 2])
    elif fmt == "codebook":
        u = torch.randn(shape, generator=gen, device=dev) / math.sqrt(k)
    return packed, u


def check_kernel(name, B, k, o, q, g, dtype, gen, out_dims=None, s_dtype=None):
    """One kernel vs its plain version at one shape, x in ``dtype`` and the
    scales in ``s_dtype`` (default: ``dtype``), and against itself on a
    rerun (same bits) → record dict."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.kernels import dequant_materialize, dequant_materialize_plain

    fn, plain = kernel_fns()[name]
    fmt = KERNELS[name][3]
    f = get_format(fmt)
    s_dtype = s_dtype or dtype
    x = torch.randn((B, k), generator=gen, device=DEVICE).to(dtype)
    planes, scale_elems = f.planes(q), math.prod(f.scales_shape(q, k // g, o))
    wbytes = planes * (k // 8) * o + scale_elems * torch.finfo(s_dtype).bits // 8
    weights = []
    for _ in range(n_copies(wbytes)):
        packed, scales = format_planes(fmt, k, o, q, g, gen)
        weights.append((packed, scales.to(s_dtype)))
    packed, scales = weights[0]
    call = (lambda p, s: fn(x, p, s, g=g, out_dims=out_dims)) if out_dims else (lambda p, s: fn(x, p, s, g=g))
    y = call(packed, scales)
    y = torch.cat(y, dim=-1) if out_dims else y
    torch.cuda.synchronize()
    ref = plain(x, packed, scales, g=g)
    err = (y - ref).abs().max().item()
    again = call(packed, scales)
    same_bits = bool(torch.equal(torch.cat(again, dim=-1) if out_dims else again, y))
    tol = KERNEL_TOL
    ok = bool(torch.allclose(y, ref, rtol=tol, atol=tol)) and bool(torch.isfinite(y).all()) and same_bits
    extra = {}
    if name == "dequant_materialize":
        # the kernel: materialise (k, o) f32, held to its plain version bit for bit
        w = dequant_materialize(packed, scales, g=g)
        exact = bool(torch.equal(w, dequant_materialize_plain(packed, scales, g=g)))
        ok = ok and exact
        xf = x.float()
        extra = dict(materialize_exact=exact, dequant_mm_ms=time_ms(call, weights),
                     gemm_ms=time_ms(lambda w: torch.matmul(xf, w), [(w,)]))
        del w
        ms = time_ms(lambda p, s: dequant_materialize(p, s, g=g), weights)
        plain_ms = time_ms(lambda p, s: dequant_materialize_plain(p, s, g=g), [(packed, scales)], reps=3, inner=2)
        nbytes = wbytes + k * o * 4  # planes and scales read, the dense f32 weight written
        ops = 2.0 * k * o  # a product and a sum per weight, f32
        ops_ms = ops / PEAK_OPS[torch.float32] * 1e3
    else:
        ms = time_ms(call, weights)
        plain_ms = time_ms(lambda p, s: plain(x, p, s, g=g), [(packed, scales)], reps=3, inner=2)
        nbytes = x.numel() * x.element_size() + wbytes + B * o * 4
        ops_ms = 2.0 * B * k * o / PEAK_OPS[torch.promote_types(dtype, s_dtype)] * 1e3
    # library yardstick: bf16 x @ pre-dequantized bf16 weight
    w16 = f.dequantize(QuantizedTensor(packed=packed, scales=scales, g=g, k=k, o=o, fmt=fmt),
                       dtype=torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    lib_ws = [(w16,)] + [(w16.clone(),) for _ in range(n_copies(w16.numel() * 2) - 1)]
    library_ms = time_ms(lambda w: torch.matmul(x16, w), lib_ws)
    del lib_ws, w16
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rec = dict(
        kernel=name, format=fmt, B=B, k=k, o=o, q=planes, g=g, dtype=str(dtype).replace("torch.", ""),
        s_dtype=str(s_dtype).replace("torch.", ""), max_abs_err=err, tol=tol, same_bits=same_bits, ok=ok,
        ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations", **extra,
    )
    more = "".join(f"  {key} {val:.4f}" for key, val in extra.items() if key.endswith("_ms"))
    log(
        f"  {name:19s} B={B:<3d} k={k:<5d} o={o:<6d} q={planes} g={g:<4d} {rec['dtype']:8s} "
        f"{'' if s_dtype == dtype else 'scales ' + rec['s_dtype'] + ' '}"
        f"err {err:.2e} (tol {tol:g}) bits {'same' if same_bits else 'DIFFER'} {'ok' if ok else 'FAIL'}  ms {ms:.4f}  "
        f"plain {plain_ms:.4f}  bound {rec['bound_ms']:.4f} ({rec['bound_by']})  library {library_ms:.4f}"
        f"{more}"
    )
    return rec


def phase_kernels(gen):
    records = []
    prefill_rows = PROMPTS * PROMPT_LEN
    for name, (_, _, leaves, _) in KERNELS.items():
        for leaf in leaves:
            k, o, dims = LEAVES[leaf]
            for B in (1, PROMPTS, prefill_rows):
                for dtype, s_dtype in DTYPE_PAIRS.get(name, SAME_DTYPES):
                    out_dims = dims if name == "bcq_mm_fused" else None
                    rec = check_kernel(name, B, k, o, Q, G, dtype, gen, out_dims, s_dtype)
                    rec["leaf"] = leaf
                    records.append(rec)
        for B, k, o, q, g in SWEEP:
            for dtype, s_dtype in DTYPE_PAIRS.get(name, SAME_DTYPES):
                out_dims = (o // 2, o - o // 2) if name == "bcq_mm_fused" else None
                rec = check_kernel(name, B, k, o, q, g, dtype, gen, out_dims, s_dtype)
                rec["leaf"] = "sweep"
                records.append(rec)
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} kernel checks disagree with their plain versions: {bad[:3]}")
    every_width = (1, PROMPTS, prefill_rows)
    for name, batches in (("codebook_mm", every_width), ("lutgemm", (1, PROMPTS)), ("bcq_mm", every_width),
                          ("bcq_mm_fused", every_width), ("uniform_mm", every_width), ("ternary_mm", every_width)):
        for r in records:
            if r["kernel"] == name and r["leaf"] != "sweep" and is_bf16(r) and r["B"] in batches:
                log(f"  {name:12s} {r['leaf']:9s} B={r['B']:<3d} {r['ms'] * 1e3:9.2f} us = "
                    f"{r['ms'] / r['bound_ms']:6.1f}x its bound ({r['bound_by']}), "
                    f"{r['ms'] / r['library_ms']:5.2f}x the library")
    # the paper's Table 3 comparison: one decode step on each path's kernels against cuBLAS
    for path, names in STEP_PATHS.items():
        for B in (1, PROMPTS, prefill_rows):
            step = path_step(records, names, B)
            log(f"  {path} decode step B={B} bf16: {step['ms']:.3f} ms, library {step['library_ms']:.3f} ms "
                f"({step['ms'] / step['library_ms']:.2f}x), bound {step['bound_ms']:.3f} ms")
    rows_equal_solo(gen)
    return records


def is_bf16(r):
    """A record of bf16 x with bf16 scales, the bf16 model's main path."""
    return r["dtype"] == "bfloat16" and r.get("s_dtype", r["dtype"]) == "bfloat16"


def step_counts(n_layers):
    """How often one decode step of llama3.2-3b runs each leaf: once a layer, ``lm_head`` once."""
    return {"wqkv": n_layers, "wo": n_layers, "w_gate_up": n_layers, "w_down": n_layers, "lm_head": 1}


def decode_step(records, name, B, n_layers=28):
    """``name``'s bf16 times at batch ``B`` summed over one decode step of
    llama3.2-3b (each leaf once a layer, ``lm_head`` once)."""
    every = step_counts(n_layers)
    rs = [(r, every[r["leaf"]]) for r in records
          if r["kernel"] == name and r["leaf"] in every and r["B"] == B and is_bf16(r)]
    return {key: sum(r[key] * n for r, n in rs) for key in ("ms", "library_ms", "bound_ms", "plain_ms")}


def path_step(records, names, B, n_layers=28):
    """The bf16 decode step at batch ``B`` of a path whose leaves ``names``
    serve between them (K1 + K2 for bcq)."""
    steps = [decode_step(records, name, B, n_layers) for name in names]
    return {key: sum(st[key] for st in steps) for key in steps[0]}


# a decode step's kernels, by path: K3 alone, bcq's K1 + K2, K5 alone, K4 (tensor cores) alone
STEP_PATHS = {"lutgemm": ("lutgemm",), "bcq (bcq_mm + bcq_mm_fused)": ("bcq_mm", "bcq_mm_fused"),
              "uniform_mm": ("uniform_mm",), "ternary_mm": ("ternary_mm",)}


def rows_equal_solo(gen, B=16):
    """Batch invariance at ``wo``: each row of a ``B``-row call of K3, K1,
    K2, K5 and K4, and of a K1 and a K4 call 8 rows wider than their row
    slab (two launches), equals the same row called alone, bit for bit, in
    bf16 and f32 (for K4: the tensor-core path and the group-table path)."""
    from repro_torch.kernels import grouptable
    from repro_torch.kernels.ternary_mm import tc_plan

    k, o, _ = LEAVES["wo"]
    fns = kernel_fns()
    bcq_slab = grouptable.plan("bcq", k, o, Q, G, torch.bfloat16, torch.bfloat16).slab_rows(1 << 20)

    def ternary_slab(dtype):  # bf16: the tensor-core plan's slab; f32: the group-table plan's
        if dtype == torch.bfloat16:
            return tc_plan(k, o, G).slab_rows(1 << 20)
        return grouptable.plan("ternary", k, o, 2, G, dtype, dtype).slab_rows(1 << 20)

    if max(bcq_slab, ternary_slab(torch.bfloat16), ternary_slab(torch.float32)) >= 1 << 20:
        raise SystemExit("chip_smoke: a plan at wo takes no row slabs; the slab check needs a split")

    for name, slab in (("lutgemm", None), ("bcq_mm", None), ("bcq_mm_fused", None), ("uniform_mm", None),
                       ("ternary_mm", None), ("bcq_mm", lambda d: bcq_slab), ("ternary_mm", ternary_slab)):
        fn = fns[name][0]
        dims = (o // 2, o - o // 2) if name == "bcq_mm_fused" else None

        def call(x, p, s):
            return torch.cat(fn(x, p, s, g=G, out_dims=dims), dim=-1) if dims else fn(x, p, s, g=G)

        for dtype in (torch.bfloat16, torch.float32):
            rows = B if slab is None else slab(dtype) + 8
            x = torch.randn((rows, k), generator=gen, device=DEVICE).to(dtype)
            packed, scales = format_planes(KERNELS[name][3], k, o, Q, G, gen)
            scales = scales.to(dtype)
            full = call(x, packed, scales)
            differ = [r for r in range(rows) if not torch.equal(call(x[r : r + 1], packed, scales), full[r : r + 1])]
            log(f"  {name} wo rows of B={rows} against each row alone, {str(dtype).replace('torch.', '')}: "
                f"{rows - len(differ)}/{rows} bitwise equal")
            if differ:
                raise SystemExit(f"chip_smoke: {name} rows {differ[:8]} of a {rows}-row call differ from the row "
                                 f"called alone")


def table_limit(gen, B=PROMPTS):
    """K1 and K5 at ``wo`` (bf16, B = 4) for q = 1..8, and K4's group-table
    path (f32 x, bf16 alpha: the f32 model's; q = 2 planes), on the table
    path and the direct path, each held to its plain version and timed: the
    measurement behind ``grouptable.TABLE_MAX_Q`` → records."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import (bcq_mm, bcq_mm_plain, grouptable, ternary_mm, ternary_mm_plain, uniform_mm,
                                     uniform_mm_plain)

    k, o, _ = LEAVES["wo"]
    plan = grouptable.plan
    records = []
    try:
        for name, fn, plain, fmt, qs, x_dtype in (
                ("bcq_mm", bcq_mm, bcq_mm_plain, "bcq", range(1, 9), torch.bfloat16),
                ("uniform_mm", uniform_mm, uniform_mm_plain, "uniform", range(1, 9), torch.bfloat16),
                ("ternary_mm", ternary_mm, ternary_mm_plain, "ternary", (2,), torch.float32)):
            for q in qs:
                x = torch.randn((B, k), generator=gen, device=DEVICE).to(x_dtype)
                f = get_format(fmt)
                weights = []
                for _ in range(n_copies(f.planes(q) * k // 8 * o)):
                    packed, scales = format_planes(fmt, k, o, q, G, gen)
                    weights.append((packed, scales.to(torch.bfloat16)))
                ref = plain(x, *weights[0], g=G)
                row = dict(kernel=name, q=q, chosen="table" if q <= grouptable.TABLE_MAX_Q[fmt] else "direct")
                for path in ("table", "direct"):
                    grouptable.plan = functools.partial(plan, table=path == "table")
                    err = (fn(x, *weights[0], g=G) - ref).abs().max().item()
                    if not err <= KERNEL_TOL:
                        raise SystemExit(f"chip_smoke: {name} q={q} {path} path differs from its plain version: {err}")
                    row[f"{path}_ms"] = time_ms(lambda p, s: fn(x, p, s, g=G), weights)
                    row[f"{path}_err"] = err
                grouptable.plan = plan
                log(f"  {name:10s} wo B={B} q={q} x {str(x_dtype).replace('torch.', '')}: "
                    f"table {row['table_ms'] * 1e3:8.2f} us, direct "
                    f"{row['direct_ms'] * 1e3:8.2f} us (errors {row['table_err']:.1e} / {row['direct_err']:.1e}); "
                    f"the plan takes the {row['chosen']} path")
                records.append(row)
    finally:
        grouptable.plan = plan
    return records


def dense_rows_check(gen):
    """Queue 3's repair, asserted: dense bf16 linears (``utils.matmul_rows``)
    and ``dequant_mm`` told its rows are decode rows give each row of a B-row
    call the bits of the row called alone, at B in {4, 9, 16, 64}, at
    ``wo`` and ``w_gate_up``; tolerance 0. Then what the repair costs: per
    leaf at B = 1, 4 and 64, one product before (``torch.matmul``; for
    ``dequant`` materialise, then one f32 product) against the row tiles
    after, summed over a decode step → dict of records and steps."""
    from repro_torch.kernels import dequant_materialize, dequant_mm
    from repro_torch.utils import ROW_TILE, matmul_rows

    out = []
    for leaf in ("wo", "w_gate_up"):
        k, o, _ = LEAVES[leaf]
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        packed, scales = format_planes("dequant", k, o, Q, G, gen)
        scales = scales.to(torch.bfloat16)
        for B in (4, 9, 16, 64):
            x = torch.randn((B, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            for path, call in (("dense bf16", lambda a: matmul_rows(a[:, None], w16)[:, 0]),
                               ("dequant_mm", lambda a: dequant_mm(a, packed, scales, g=G, token_rows=True))):
                full = call(x).float()
                alone = torch.cat([call(x[r : r + 1]) for r in range(B)]).float()
                diff = (full - alone).abs().max().item()
                rows = int((full != alone).any(dim=-1).sum())
                log(f"  {path:10s} {leaf:9s} B={B:<2d}: {rows}/{B} rows differ from the row alone, "
                    f"max|d| {diff:.3e} (tolerance 0)")
                out.append(dict(path=path, leaf=leaf, B=B, rows_differ=rows, max_abs_diff=diff))
    bad = [r for r in out if r["rows_differ"]]
    if bad:
        raise SystemExit(f"chip_smoke: dense / dequant rows differ from the row alone: {bad[:4]}")

    costs, steps = [], {}
    widths = (1, PROMPTS, PROMPTS * PROMPT_LEN)
    for leaf, (k, o, _) in LEAVES.items():
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        ws = [(w16,)] + [(w16.clone(),) for _ in range(n_copies(w16.numel() * 2) - 1)]
        qs = []
        for _ in range(n_copies(Q * k // 8 * o)):
            packed, scales = format_planes("dequant", k, o, Q, G, gen)
            qs.append((packed, scales.to(torch.bfloat16)))
        for B in widths:
            x = torch.randn((B, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            xf = x.float()
            rec = dict(leaf=leaf, B=B,
                       dense_before_ms=time_ms(lambda w: torch.matmul(x, w), ws),
                       dense_after_ms=time_ms(lambda w: matmul_rows(x[:, None], w), ws),
                       dequant_before_ms=time_ms(lambda p, s: torch.matmul(xf, dequant_materialize(p, s, g=G)), qs),
                       dequant_after_ms=time_ms(lambda p, s: dequant_mm(x, p, s, g=G, token_rows=True), qs))
            log(f"  cost at {leaf:9s} B={B:<3d}: dense bf16 {rec['dense_before_ms'] * 1e3:8.2f} -> "
                f"{rec['dense_after_ms'] * 1e3:8.2f} us, dequant {rec['dequant_before_ms'] * 1e3:8.2f} -> "
                f"{rec['dequant_after_ms'] * 1e3:8.2f} us")
            costs.append(rec)
        del ws, w16, qs
    every = step_counts(28)
    for B in widths:
        steps[B] = {key: sum(r[key] * every[r["leaf"]] for r in costs if r["B"] == B)
                    for key in ("dense_before_ms", "dense_after_ms", "dequant_before_ms", "dequant_after_ms")}
        st = steps[B]
        log(f"  decode step B={B} (28 layers): dense bf16 {st['dense_before_ms']:.3f} -> "
            f"{st['dense_after_ms']:.3f} ms, dequant {st['dequant_before_ms']:.3f} -> "
            f"{st['dequant_after_ms']:.3f} ms (before: one product; after: tiles of {ROW_TILE} rows)")
    return dict(rows=out, costs=costs, steps=steps)


def flash_plain_rows(q, k, v):
    """K8's plain version one batch row at a time: the same function (rows
    are independent), with one row's ``(H, S, S)`` f32 logits live at once."""
    from repro_torch.kernels import flash_attention_plain

    return torch.cat([flash_attention_plain(q[b : b + 1], k[b : b + 1], v[b : b + 1])
                      for b in range(q.shape[0])])


def sdpa_library(q, k, v):
    """The library yardstick: one fused PyTorch attention call on the same
    (B, S, H, Dh) inputs. Timed only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True
    ).transpose(1, 2)


def check_flash(B, S, H, Hkv, Dh, dtype, gen):
    """K8 vs its plain version at one shape → record dict."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attn import BF16_ROW_TOL, row_rel_err

    def rand(heads):
        return torch.randn((B, S, heads, Dh), generator=gen, device=DEVICE).to(dtype)

    nbytes = (2 * B * S * H * Dh + 2 * B * S * Hkv * Dh) * (4 if dtype == torch.float32 else 2)
    inputs = [(rand(H), rand(Hkv), rand(Hkv)) for _ in range(n_copies(nbytes))]
    q, k, v = inputs[0]
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_plain_rows(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    row_err = row_rel_err(out, ref)
    tol = FLASH_TOL[dtype]
    within = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))  # the reference test's assert
    del ref
    same_bits = bool(torch.equal(flash_attention(q, k, v), out))
    row_tol = BF16_ROW_TOL if dtype == torch.bfloat16 else None
    ok = (within and (row_tol is None or row_err <= row_tol) and same_bits
          and bool(torch.isfinite(out).all()) and out.dtype == dtype)
    ms = time_ms(flash_attention, inputs)
    plain_ms = time_ms(flash_plain_rows, [(q, k, v)], reps=3, inner=1)
    library_ms = time_ms(sdpa_library, inputs) if dtype == torch.bfloat16 else None
    # the work this data needs: q k^T and p v over the S(S+1)/2 causal pairs
    ops = 4.0 * B * H * Dh * (S * (S + 1) / 2)
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rec = dict(
        kernel=FLASH[0], B=B, S=S, H=H, Hkv=Hkv, Dh=Dh, dtype=str(dtype).replace("torch.", ""),
        max_abs_err=err, tol=tol, row_rel_err=row_err, row_tol=row_tol, same_bits=same_bits, ok=ok,
        ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    rec["tflops"] = ops / ms / 1e9
    rec["library_tflops"] = None if library_ms is None else ops / library_ms / 1e9
    lib = "-" if library_ms is None else f"{library_ms:.4f} ({rec['library_tflops']:.1f} TFLOP/s)"
    log(f"  flash_attention B={B} S={S:<5d} H={H:<2d}/{Hkv:<2d} Dh={Dh:<3d} {rec['dtype']:8s} "
        f"err {err:.2e} (rtol = atol = {tol:g}) row {row_err:.2e}{'' if row_tol is None else f' (tol {row_tol:g})'} "
        f"bits {'same' if same_bits else 'DIFFER'} {'ok' if ok else 'FAIL'}  "
        f"ms {ms:.4f} ({rec['tflops']:.1f} TFLOP/s)  plain {plain_ms:.4f}  "
        f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})  library {lib}")
    return rec


def phase_flash(gen):
    H, Hkv, Dh = LLAMA_HEADS
    shapes = [(B, S, H, Hkv, Dh) for B in (1, PROMPTS) for S in FLASH_S] + FLASH_EXTRA
    records = [check_flash(*shape, dtype, gen) for shape in shapes
               for dtype in (torch.bfloat16, torch.float32)]
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} flash_attention checks disagree with the plain version: {bad[:3]}")
    return records


def run_counted(fn):
    """``fn()`` with every launch count set to 0 just before it and read just
    after → (result, wall seconds, launch counts, ref-oracle dispatches)."""
    from repro_torch.kernels import launch_counts, qmatmul, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    ref0 = qmatmul.ref_calls
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, launch_counts(), qmatmul.ref_calls - ref0


def quantized_engine(cfg, params, fmt):
    """Quantize the dense ``params`` on the card in ``fmt`` and build the
    serving engine (fused QKV / gate-up)."""
    from repro_torch.infer import Engine
    from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quantize_params(params, QuantPolicy(q=Q, g=G, iters=4, fmt=fmt), device="cuda")
    torch.cuda.synchronize()
    log(f"  [{fmt}] quantize_params {time.perf_counter() - t0:.1f}s "
        f"({quantized_bytes(qparams) / 1e9:.3f} GB packed; solver peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB above the dense model)")
    return Engine(cfg, qparams, max_seq=PROMPT_LEN + NEW_TOKENS + 8, device="cuda")


def check_tokens(cfg, results):
    for res in results:
        if res.tokens.shape[1] != PROMPT_LEN + NEW_TOKENS or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)
        ).all():
            raise SystemExit(f"chip_smoke: bad generated tokens {res.tokens.shape}")


def check_logits(engine, prompts, fmt, modes):
    """Each mode's prefill + one step logits vs the ref oracle's, within
    ``LOGITS_REL_TOL`` of max|ref| → worst relative error."""
    ref_logits = step_logits(engine, prompts, "ref")
    scale = ref_logits.abs().max().item()
    worst = 0.0
    for mode in modes:
        got = step_logits(engine, prompts, mode)
        if not torch.isfinite(got).all():
            raise SystemExit(f"chip_smoke: non-finite logits ({fmt}, {mode or 'auto'})")
        err = (got - ref_logits).abs().max().item()
        agree = (got.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
        log(f"  [{fmt}] logits {mode or 'auto'} vs ref: max|d| {err:.4e} of max|ref| {scale:.3f} "
            f"(tol {LOGITS_REL_TOL:g} relative), top-1 agreement {agree:.3f}")
        worst = max(worst, err / scale)
    if not worst <= LOGITS_REL_TOL:
        raise SystemExit(f"chip_smoke: [{fmt}] engine logits differ from the ref oracle by {worst:.3e} relative")
    return worst


def f32_oracle_engine(engine):
    """The same quantized weights, dequantized to f32, in an f32 model (the
    watch item's oracle, ROADMAP Queue 3)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.infer import Engine
    from repro_torch.utils import tree_map

    def to_f32(leaf):
        if not isinstance(leaf, QuantizedTensor):
            return leaf.to(torch.float32)
        f = get_format(leaf.fmt)
        if leaf.packed.dim() == 3:
            return f.dequantize(leaf, dtype=torch.float32)
        return torch.stack([f.dequantize(leaf.replace(packed=leaf.packed[i], scales=leaf.scales[i]),
                                         dtype=torch.float32) for i in range(leaf.packed.shape[0])])

    cfg32 = dataclasses.replace(engine.cfg, param_dtype="float32", compute_dtype="float32")
    return Engine(cfg32, tree_map(to_f32, engine.params), max_seq=engine.max_seq, fuse=False, device="cuda")


def f32_oracle_check(engine, prompts, fmt, modes):
    """Each bf16 path's logits (the ref path's included) against the f32
    oracle under ``impl_mode("ref")``, max|d| / max|f32|. A kernel path no
    farther from it than the ref path is not at fault, whatever their
    distance from each other."""
    oracle = f32_oracle_engine(engine)
    want = step_logits(oracle, prompts, "ref")
    del oracle
    scale = want.abs().max().item()
    out = {}
    for mode in ("ref", *modes):
        got = step_logits(engine, prompts, mode)
        out[mode or "auto"] = (got - want).abs().max().item() / scale
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"  [{fmt}] logits {mode or 'auto'} vs the f32-weight oracle: max|d| / max|f32| "
            f"{out[mode or 'auto']:.3e}, top-1 agreement {agree:.3f}")
    return out


def serve_bcq(cfg, params, prompts, reqs):
    """The bcq path: batched, sequential and LUT-kernel ``generate`` in one
    counted window."""
    import numpy as np

    from repro_torch.kernels import impl_mode
    from repro_torch.launch.serve import drive_sequential

    engine = quantized_engine(cfg, params, "bcq")
    engine.generate(prompts, 2)  # warm-up: library handles, allocator

    def run():
        t0 = time.perf_counter()
        batched = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        seq_outs, t_seq = drive_sequential(engine, reqs, np.zeros(len(reqs)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with impl_mode("lutgemm"):
            lut = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        return batched, t_batched, seq_outs, t_seq, lut, time.perf_counter() - t0

    (batched, t_batched, seq_outs, t_seq, lut, t_lut), _, counts, ref_calls = run_counted(run)
    n_tok = PROMPTS * NEW_TOKENS
    log(f"  [bcq] generate batched ({PROMPTS}x{PROMPT_LEN} + {NEW_TOKENS}): {t_batched:.3f}s, "
        f"{n_tok / t_batched:.1f} tok/s")
    log(f"  [bcq] generate sequential ({PROMPTS} requests): {t_seq:.3f}s, {n_tok / t_seq:.1f} tok/s")
    log(f"  [bcq] generate batched on lutgemm: {t_lut:.3f}s, {n_tok / t_lut:.1f} tok/s")
    log(f"  [bcq] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")

    L = cfg.n_layers
    forwards = 1 + NEW_TOKENS  # prefill + one forward per sampled token
    expect = dict.fromkeys(counts, 0)
    expect.update({
        "bcq_mm": (1 + PROMPTS) * forwards * (2 * L + 1),
        "bcq_mm_fused": (1 + PROMPTS) * forwards * 2 * L,
        "lutgemm": forwards * (4 * L + 1),
        "flash_attention": (2 + PROMPTS) * L,  # every prefill's attention, one launch a layer
    })
    if counts != expect:
        raise SystemExit(f"chip_smoke: [bcq] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the bcq path took the ref oracle {ref_calls} times")
    check_tokens(cfg, [batched, lut, *seq_outs])
    seq_tokens = np.concatenate([o.tokens for o in seq_outs])
    log(f"  [bcq] greedy rows identical, batched vs sequential: "
        f"{int((seq_tokens == batched.tokens).all(axis=1).sum())}/{PROMPTS}; "
        f"bcq_mm vs lutgemm: {int((lut.tokens == batched.tokens).all(axis=1).sum())}/{PROMPTS}")
    check_logits(engine, prompts, "bcq", (None, "lutgemm"))
    f32_rel = f32_oracle_check(engine, prompts, "bcq", (None, "lutgemm"))
    small_model_check("bcq")
    summary = dict(tok_s=n_tok / t_batched, wall_s=t_batched, seq_tok_s=n_tok / t_seq,
                   lutgemm_tok_s=n_tok / t_lut, f32_oracle_rel=f32_rel,
                   profile=profile_generate(engine, prompts, t_batched, "bcq"))
    return {k: counts[k] for k in ("bcq_mm", "bcq_mm_fused", "lutgemm")}, summary, engine


def serve_format(cfg, params, prompts, fmt):
    """One of the other formats' paths: batched ``generate`` in a counted
    window → (its kernel's launches, tokens, summary)."""
    from repro_torch.kernels import ternary_mm

    engine = quantized_engine(cfg, params, fmt)
    engine.generate(prompts, 2)  # warm-up
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS))
    peak = torch.cuda.max_memory_allocated()
    tc_launches = ternary_mm.tc_launches
    kernel = FORMAT_KERNEL[fmt]
    n_tok = PROMPTS * NEW_TOKENS
    log(f"  [{fmt}] generate batched ({PROMPTS}x{PROMPT_LEN} + {NEW_TOKENS}): {dt:.3f}s, "
        f"{n_tok / dt:.1f} tok/s; peak device memory {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} GB above the resident {base / 1e9:.3f} GB")
    log(f"  [{fmt}] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    expect = dict.fromkeys(counts, 0)
    expect[kernel] = (1 + NEW_TOKENS) * (4 * cfg.n_layers + 1)
    expect["flash_attention"] = cfg.n_layers  # the prefill's attention
    if counts != expect:
        raise SystemExit(f"chip_smoke: [{fmt}] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the {fmt} path took the ref oracle {ref_calls} times")
    # the bf16 model's ternary linears all take K4's tensor cores, no other path
    expect_tc = expect["ternary_mm"]
    if fmt == "ternary":
        log(f"  [{fmt}] of them on K4's tensor cores: {tc_launches} (expected {expect_tc})")
    if tc_launches != expect_tc:
        raise SystemExit(f"chip_smoke: [{fmt}] K4 took its tensor-core path {tc_launches} times, not {expect_tc}")
    check_tokens(cfg, [res])
    check_logits(engine, prompts, fmt, (None,))
    small_model_check(fmt)
    summary = dict(tok_s=n_tok / dt, wall_s=dt, peak_gb=peak / 1e9, transient_gb=(peak - base) / 1e9,
                   tc_launches=tc_launches, profile=profile_generate(engine, prompts, dt, fmt))
    return counts[kernel], res.tokens, summary, engine


def phase_main_path():
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models import init_params
    from repro_torch.quant import quantized_bytes

    cfg = get_config("llama3.2-3b")
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, layers {cfg.n_layers}, {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f}s ({quantized_bytes(params) / 1e9:.3f} GB dense)")
    reqs = build_requests(cfg, PROMPTS, PROMPT_LEN, NEW_TOKENS, mixed_temperature=False)
    prompts = np.stack([r.prompt for r in reqs])

    from repro_torch.kernels import flash_attention

    flash_attention.copies = 0
    counts, summary, bcq_engine = serve_bcq(cfg, params, prompts, reqs)
    summaries = {"bcq": summary}
    tokens = {}
    for fmt, kernel in FORMAT_KERNEL.items():
        counts[kernel], tokens[fmt], summaries[fmt], engine = serve_format(cfg, params, prompts, fmt)
        if fmt == "ternary":
            ternary_engine = engine  # phase 7 speculates on it
        del engine
    counts["ternary_mm_tc"] = summaries["ternary"]["tc_launches"]
    same = int((tokens["uniform"] == tokens["dequant"]).all(axis=1).sum())
    log(f"  greedy rows identical, uniform vs dequant: {same}/{PROMPTS} (reported, not asserted: "
        f"the two kernels sum k in different orders)")
    log(f"  K8 inputs copied for the TMA's alignment on the main path: {flash_attention.copies}")
    if flash_attention.copies:
        raise SystemExit("chip_smoke: the model's q, k, v views did not reach K8 in place")
    return counts, cfg, summaries, bcq_engine, ternary_engine, prompts


def serving_engine(engine, max_seq):
    """The bcq engine's fused weights behind another cache length (no copy)."""
    from repro_torch.infer import Engine

    return Engine(engine.cfg, engine.params, max_seq=max_seq, fuse=False, device="cuda")


def serve_requests(cfg, lens, new_tokens, seed0):
    """One request per prompt length, prompts from the serve launcher's
    Markov corpus; temperatures cycle 0 (greedy), 1.0, 0.7."""
    import numpy as np

    from repro_torch.data import MarkovCorpus
    from repro_torch.infer import Request

    corpus = MarkovCorpus(cfg.vocab, seed=3)
    return [
        Request(prompt=corpus.sample(1, n, seed=seed0 + i)[0, :n].astype(np.int32),
                max_new_tokens=new_tokens, temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
        for i, n in enumerate(lens)
    ]


def expect_forward_counts(counts, forwards, prefills, n_layers):
    """Launch counts of the bcq path over ``forwards`` forwards, ``prefills``
    of them prefills (each launching K8 once a layer)."""
    expect = dict.fromkeys(counts, 0)
    expect.update(bcq_mm=forwards * (2 * n_layers + 1), bcq_mm_fused=forwards * 2 * n_layers,
                  flash_attention=prefills * n_layers)
    return expect


def slot_vs_solo_logits(engine, reqs):
    """Largest |logit difference| between a slot batch and solo batch-1
    forwards of the same requests: their prefill logits and one decode
    step's."""
    slots = engine.init_slots(len(reqs))
    for i, r in enumerate(reqs):
        engine.admit_slot(slots, i, r.prompt, max_new_tokens=2)
    prefill = slots["logits"].clone()
    toks, _, slots = engine.decode_slots(slots, 1)
    worst = 0.0
    for i, r in enumerate(reqs):
        l0, cache = engine.prefill(torch.as_tensor(r.prompt[None], device=DEVICE).long(), engine._make_cache(1))
        l1, _ = engine.decode(torch.tensor([[int(toks[i, 0])]], device=DEVICE), cache, r.prompt.size)
        worst = max(worst, (l0[0] - prefill[i]).abs().max().item(), (l1[0] - slots["logits"][i]).abs().max().item())
    return worst


def device_profile(run, cross_check=False):
    """Device busy time by kernel over ``run()``, traced with
    ``torch.profiler`` (CUDA activity only, which slows the host least) →
    (device ms, traced wall ms, {kernel: ms}). The device activities are
    summed straight from the trace's events (``kineto_results``, a private
    attribute, checked on torch 2.11): ``key_averages()`` builds a Python
    object per event (~70 us each), a minute for the ~10^5 kernels of a
    speculative run. Without that attribute the sum falls back to
    ``key_averages()``; ``cross_check`` computes both and fails unless they
    agree within 0.1% plus a microsecond an event (the rounding of the
    public sum)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    fast = _trace_device_ms(prof)
    if fast is None or cross_check:
        public = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                public[ev.key] = public.get(ev.key, 0.0) + us / 1e3
        if fast is None:
            return sum(public.values()), traced_ms, public
        n_events, by_name = fast
        a, b = sum(by_name.values()), sum(public.values())
        log(f"  device_profile cross-check (torch {torch.__version__}): trace events {a:.3f} ms over {n_events} "
            f"events, key_averages() {b:.3f} ms")
        if abs(a - b) > 1e-3 * b + 1e-3 * n_events:
            raise SystemExit(f"chip_smoke: the trace's device events sum to {a:.3f} ms, key_averages() to "
                             f"{b:.3f} ms: the profiler's private event list changed meaning")
    return sum(fast[1].values()), traced_ms, fast[1]


def _trace_device_ms(prof):
    """(events, {kernel: ms}) of the trace's device activities, or None where
    this torch has no ``kineto_results`` event list."""
    try:
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
    except (AttributeError, ImportError):
        return None
    by_name, n = {}, 0
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
            n += 1
    return n, by_name


def phase_serving(bcq_engine):
    """Continuous batching of 12 requests (ragged prompts, greedy and
    sampled) through 4 slots on the bcq model → (K8 launches, summary)."""
    import numpy as np

    from repro_torch.launch.serve import drive_continuous

    cfg = bcq_engine.cfg
    L, n = cfg.n_layers, len(SERVE_PROMPT_LENS)
    engine = serving_engine(bcq_engine, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)

    def serve(seed0):
        reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, seed0)
        sched, done, wall = drive_continuous(engine, reqs, np.zeros(n), n_slots=SERVE_SLOTS,
                                             chunk=SERVE_CHUNK)
        return reqs, sched, done, wall

    drive_continuous(engine, serve_requests(cfg, (16, 40), 2, 900), np.zeros(2), n_slots=SERVE_SLOTS,
                     chunk=SERVE_CHUNK)  # warm-up
    (reqs, sched, done, wall), _, counts, ref_calls = run_counted(lambda: serve(200))
    summ = sched.summary()
    tok_s = n * NEW_TOKENS / wall
    util = sched.steps_active / max(1, sched.decode_steps * SERVE_SLOTS)
    ttft = summ["ttft_s"]
    log(f"  [continuous] {n} requests (prompts {min(SERVE_PROMPT_LENS)}-{max(SERVE_PROMPT_LENS)} tokens, "
        f"{NEW_TOKENS} new each), {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}: {wall:.3f}s, {tok_s:.1f} tok/s, "
        f"slot utilisation {util:.1%}, TTFT p50 {ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s, "
        f"{sched.decode_steps} decode steps")
    log(f"  [continuous] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    expect = expect_forward_counts(counts, n + sched.decode_steps, n, L)
    if counts != expect:
        raise SystemExit(f"chip_smoke: [continuous] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the continuous path took the ref oracle {ref_calls} times")
    if len(done) != n or summ["by_state"] != {"finished": n}:
        raise SystemExit(f"chip_smoke: [continuous] not every request finished: {summ['by_state']}")

    by_rid = {c.rid: c.new_tokens for c in done}
    t0 = time.perf_counter()
    solos, _, solo_counts, _ = run_counted(lambda: [
        engine.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
        for r in reqs])
    solo_s = time.perf_counter() - t0
    if solo_counts["flash_attention"] != n * L:
        raise SystemExit(f"chip_smoke: solo generates launched K8 {solo_counts['flash_attention']} times, "
                         f"not {n * L}")
    same = [bool(np.array_equal(by_rid[r.rid], o.tokens[0, r.prompt.size:])) for r, o in zip(reqs, solos)]
    greedy = [r.temperature == 0 for r in reqs]
    worst = slot_vs_solo_logits(engine, [r for r in reqs if r.temperature == 0][:SERVE_SLOTS])
    log(f"  [continuous] slot == solo generate: greedy {sum(a for a, g in zip(same, greedy) if g)}/{sum(greedy)}, "
        f"sampled {sum(a for a, g in zip(same, greedy) if not g)}/{n - sum(greedy)} (sampled reported, "
        f"not asserted); largest logit difference slot batch vs solo forwards {worst:.3e}; "
        f"{n} solo generates {solo_s:.3f}s ({n * NEW_TOKENS / solo_s:.1f} tok/s one at a time)")
    if not all(a for a, g in zip(same, greedy) if g):
        raise SystemExit("chip_smoke: a greedy request served in a slot differs from its solo generate")

    device_ms, traced_ms, by_name = device_profile(lambda: serve(300))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    flash_ms = sum(ms for name, ms in by_name.items() if any(t in name for t in FLASH_TAGS))
    log(f"  [continuous] profile of a second run: device busy {device_ms:.2f} ms of {traced_ms:.2f} ms traced "
        f"wall ({device_ms / traced_ms:.1%}; {device_ms / (wall * 1e3):.1%} of the untraced run's wall), "
        f"K8 {flash_ms:.2f} ms")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    summary = dict(requests=n, wall_s=wall, tok_s=tok_s, slot_utilisation=util, ttft_s=ttft,
                   tpot_s=summ["tpot_s"], decode_steps=sched.decode_steps, greedy_same=same,
                   max_logit_diff_slot_vs_solo=worst, solo_s=solo_s, device_ms=device_ms,
                   traced_wall_ms=traced_ms, busy_share=device_ms / (wall * 1e3), flash_ms=flash_ms,
                   top=[[k, v] for k, v in top])
    return counts["flash_attention"], summary, dict(engine=engine, solos=solos)


def forced_logits(engine, prompt, tokens, mode):
    """Under ``impl_mode(mode)``: the prompt's prefill, then ``tokens`` fed
    one decode step at a time → the ``(len(tokens), V)`` logits that chose
    each of them (teacher forcing: every path sees the same inputs)."""
    from repro_torch.kernels import impl_mode

    out = []
    with impl_mode(mode):
        logits, cache = engine.prefill(torch.as_tensor(prompt[None], device=DEVICE).long(), engine._make_cache(1))
        for t, tok in enumerate(tokens):
            out.append(logits[0])
            if t + 1 < len(tokens):
                logits, cache = engine.decode(torch.tensor([[int(tok)]], device=DEVICE), cache, prompt.size + t)
    return torch.stack(out)


def phase_long(bcq_engine):
    """One request of LONG_SEQ_THRESHOLD prompt tokens through the
    scheduler on the kernels, and again under impl_mode("ref"); then the
    kernel path's tokens teacher-forced through both paths and an f32-weight
    oracle, so the logits are compared on the same inputs."""
    import numpy as np

    from repro_torch.infer import RequestState, Scheduler
    from repro_torch.kernels import impl_mode
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = bcq_engine.cfg
    L, S = cfg.n_layers, LONG_SEQ_THRESHOLD
    engine = serving_engine(bcq_engine, S + LONG_NEW)
    (req,) = serve_requests(cfg, (S,), LONG_NEW, 500)  # greedy

    def synced_clock():  # lifecycle stamps that include the device's work
        torch.cuda.synchronize()
        return time.perf_counter()

    def run(mode):
        with impl_mode(mode):
            sched = Scheduler(engine, n_slots=1, chunk=SERVE_CHUNK, clock=synced_clock)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rid = sched.submit(dataclasses.replace(req, rid=None))
            (c,) = sched.run()
            peak = torch.cuda.max_memory_allocated() - base
        stamps = dict(sched.outcomes[rid].history)
        prefill_s = stamps[RequestState.DECODING] - stamps[RequestState.PREFILLING]
        return c.new_tokens, prefill_s, peak, base, sched.decode_steps

    (toks, prefill_s, peak, base, steps), wall, counts, ref_calls = run_counted(lambda: run(None))
    logits_gb = LLAMA_HEADS[0] * S * S * 4 / 1e9  # _sdpa's f32 (H, S, S) logits for one layer, computed
    log(f"  [long] {S}-token prompt + {LONG_NEW} new tokens through the scheduler: {wall:.3f}s, prefill "
        f"{prefill_s:.3f}s; peak device memory {peak / 1e9:.3f} GB above the resident {base / 1e9:.3f} GB "
        f"(weights and cache); _sdpa would need {logits_gb:.2f} GB of f32 logits per layer (computed, not run)")
    log(f"  [long] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    expect = expect_forward_counts(counts, 1 + steps, 1, L)
    if counts != expect:
        raise SystemExit(f"chip_smoke: [long] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the long request took the ref oracle {ref_calls} times")
    rtoks, rprefill_s, rpeak, _, _ = run("ref")
    same = bool(np.array_equal(toks, rtoks))
    log(f"  [long] under impl_mode('ref') (_sdpa_qchunked, dequantized weights): prefill {rprefill_s:.3f}s, "
        f"peak {rpeak / 1e9:.3f} GB above the same base; free-running greedy tokens "
        f"{'identical' if same else 'differ'}: {toks.tolist()} vs {rtoks.tolist()}")

    kl = forced_logits(engine, req.prompt, toks, None)
    if not torch.equal(kl.argmax(-1).cpu(), torch.as_tensor(toks).long()):
        raise SystemExit("chip_smoke: [long] teacher-forced kernel logits do not reproduce the served tokens")
    rl = forced_logits(engine, req.prompt, toks, "ref")
    oracle = f32_oracle_engine(engine)
    fl = forced_logits(oracle, req.prompt, toks, "ref")
    del oracle

    def rel(a, b):
        return ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    top2 = rl.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    diff = (kl - rl).abs().amax(-1).tolist()
    rel_kr, rel_kf, rel_rf = rel(kl, rl), rel(kl, fl), rel(rl, fl)
    log(f"  [long] teacher-forced on the kernel path's tokens, max|d| / max|logit| per step, worst of {LONG_NEW}: "
        f"kernel vs ref {rel_kr:.3e} (tol {LOGITS_REL_TOL:g}); against the f32-weight oracle kernel "
        f"{rel_kf:.3e}, ref {rel_rf:.3e}; top-1 agreement kernel/ref {agree(kl, rl):.3f}, kernel/f32 "
        f"{agree(kl, fl):.3f}, ref/f32 {agree(rl, fl):.3f}")
    log(f"  [long] per step, the ref path's top-1/top-2 margin vs max|kernel - ref|: "
        + ", ".join(f"{m:.3f}/{d:.3f}" for m, d in zip(margin, diff)))
    if not rel_kr <= LOGITS_REL_TOL:
        raise SystemExit(f"chip_smoke: the long request's logits differ from the ref path by {rel_kr:.3e} relative")
    decisive = [m > 2 * d for m, d in zip(margin, diff)]
    flips = [t for t, dec in enumerate(decisive)
             if dec and int(kl[t].argmax()) != int(rl[t].argmax())]
    if flips:
        raise SystemExit(f"chip_smoke: [long] the kernel and ref paths pick different tokens at decisive steps {flips}")
    return dict(prompt_len=S, new_tokens=LONG_NEW, wall_s=wall, prefill_s=prefill_s, peak_gb=peak / 1e9,
                base_gb=base / 1e9, sdpa_logits_gb_per_layer=logits_gb, ref_prefill_s=rprefill_s,
                ref_peak_gb=rpeak / 1e9, tokens_identical=same, tokens=toks.tolist(), ref_tokens=rtoks.tolist(),
                rel_kernel_ref=rel_kr, rel_kernel_f32=rel_kf, rel_ref_f32=rel_rf, margins=margin,
                max_abs_diff=diff, top1_kernel_ref=agree(kl, rl), top1_kernel_f32=agree(kl, fl),
                top1_ref_f32=agree(rl, fl))


def step_logits(engine, prompts, mode):
    """Prefill and one decode step's logits ``(2, B, V)`` under ``impl_mode(mode)``."""
    from repro_torch.kernels import impl_mode

    with impl_mode(mode):
        toks = torch.as_tensor(prompts, device=engine.device, dtype=torch.long)
        l0, cache = engine.prefill(toks, engine._make_cache(len(prompts)))
        l1, _ = engine.decode(toks[:, -1:], cache, toks.shape[1])
    return torch.stack([l0, l1])


def small_model_check(fmt):
    """The engine's kernel paths against its ref-oracle path on the serve
    launcher's reduced f32 llama3.2-3b in ``fmt``, within the kernels' f32
    tolerance: in f32 nothing but summation order separates them, while the
    full-width bf16 model above also rounds activations differently at
    every layer."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import init_params, reduced
    from repro_torch.quant import QuantPolicy, quantize_params

    cfg = reduced(get_config("llama3.2-3b"), d_model=256, n_kv_heads=4, d_ff=512)
    params = quantize_params(init_params(cfg, seed=0, device="cuda"),
                             QuantPolicy(q=Q, g=G, iters=2, fmt=fmt), device="cuda")
    engine = Engine(cfg, params, max_seq=32, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8))
    ref = step_logits(engine, prompts, "ref")
    tol = KERNEL_TOL
    for mode in (None, "lutgemm") if fmt == "bcq" else (None,):
        got = step_logits(engine, prompts, mode)
        err = (got - ref).abs().max().item()
        ok = bool(torch.allclose(got, ref, rtol=tol, atol=tol))
        log(f"  [{fmt}] reduced f32 model ({cfg.n_layers} layers, d_model {cfg.d_model}): logits "
            f"{mode or 'auto'} vs ref max|d| {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: [{fmt}] reduced-model logits ({mode or 'auto'}) differ from the ref oracle")


def profile_generate(engine, prompts, untraced_s, fmt):
    """Device busy time by kernel over one batched ``generate``."""
    device_ms, traced_ms, by_name = device_profile(lambda: engine.generate(prompts, NEW_TOKENS),
                                                   cross_check=fmt == "bcq")
    if not device_ms:
        log(f"  [{fmt}] profile: torch.profiler recorded no device time; busy share not measured")
        return None
    ours_ms = sum(ms for name, ms in by_name.items() if PROFILE_TAG[fmt] in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  [{fmt}] profile of one batched generate: device busy {device_ms:.2f} ms of "
        f"{traced_ms:.2f} ms traced wall ({device_ms / traced_ms:.1%}; untraced wall "
        f"{untraced_s * 1e3:.2f} ms, busy {device_ms / (untraced_s * 1e3):.1%} of it), the format's "
        f"kernels {ours_ms:.2f} ms")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    return dict(device_ms=device_ms, traced_wall_ms=traced_ms, untraced_wall_ms=untraced_s * 1e3,
                format_kernels_ms=ours_ms, top=[[name, ms] for name, ms in top])


def draft_shapes(gen, records):
    """The speculative path's shapes (phase 3), bf16, each held to its plain
    version: K1/K2 and K3 at q' = 1 and 2 planes on the five leaves at B = 1,
    4, the verify's 4·(γ+1) = 20 rows and the draft prefill's 64 rows, at
    q = 4 at 20 rows, and K4 (the ternary verify) at 20 rows, each timed with
    its byte bound; K1/K2 at q' and q planes at each of phase 6's prompt
    lengths (the speculative scheduler's two prefills), checked only. Then
    each path's decode step at every q and B (``records`` holds the q = 4
    rows at B = 1 and 4) → (records, steps)."""
    recs = []
    widths = [(q, B) for q in DRAFT_Q for B in (1, PROMPTS, VERIFY_ROWS, PROMPTS * PROMPT_LEN)] + [(Q, VERIFY_ROWS)]
    timed_shapes = [(name, q, B) for name in ("bcq_mm", "bcq_mm_fused", "lutgemm") for q, B in widths]
    timed_shapes += [("ternary_mm", Q, VERIFY_ROWS)]
    for name, q, B in timed_shapes:
        for leaf in KERNELS[name][2]:
            k, o, dims = LEAVES[leaf]
            rec = check_kernel(name, B, k, o, q, G, torch.bfloat16, gen, dims if name == "bcq_mm_fused" else None)
            rec["leaf"] = leaf
            recs.append(rec)
    bad = [r for r in recs if not r["ok"]]
    for name in ("bcq_mm", "bcq_mm_fused"):
        for leaf in KERNELS[name][2]:
            k, o, dims = LEAVES[leaf]
            for q in (SPEC_Q, Q):
                for B in sorted(set(SERVE_PROMPT_LENS)):
                    rec = check_untimed(name, B, k, o, q, gen, dims if name == "bcq_mm_fused" else None)
                    rec["leaf"] = leaf
                    recs.append(rec)
                    bad += [] if rec["ok"] else [rec]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} draft-shape checks disagree with their plain versions: {bad[:3]}")
    log(f"  speculative path's shapes: {len(recs)} bf16 checks against the plain versions pass "
        f"(K1/K2/K3 at q'={DRAFT_Q} B={(1, PROMPTS, VERIFY_ROWS, PROMPTS * PROMPT_LEN)}, q={Q} B={VERIFY_ROWS}; "
        f"K4 B={VERIFY_ROWS}; K1/K2 at q={(SPEC_Q, Q)} over {len(set(SERVE_PROMPT_LENS))} prompt lengths)")
    steps = {}
    for path, names in (("bcq (bcq_mm + bcq_mm_fused)", ("bcq_mm", "bcq_mm_fused")), ("lutgemm", ("lutgemm",))):
        for B in (1, PROMPTS, VERIFY_ROWS):
            at = {q: path_step([r for r in records + recs if r["q"] == q and "ms" in r], names, B)
                  for q in (*DRAFT_Q, Q)}
            steps[f"{path} B={B}"] = {str(q): st for q, st in at.items()}
            log(f"  {path} decode step B={B} bf16: " + ", ".join(
                f"q={q} {st['ms']:.3f} ms (bound {st['bound_ms']:.3f})" for q, st in at.items())
                + f"; q'=2 / q=4 {at[2]['ms'] / at[Q]['ms']:.2f}x time, "
                f"{at[2]['bound_ms'] / at[Q]['bound_ms']:.2f}x bound")
    return recs, steps


def check_untimed(name, B, k, o, q, gen, out_dims=None):
    """One bf16 kernel call against its plain version and a rerun, as in
    :func:`check_kernel`, without the timings → record dict."""
    fn, plain = kernel_fns()[name]
    x = torch.randn((B, k), generator=gen, device=DEVICE).to(torch.bfloat16)
    packed, scales = format_planes(KERNELS[name][3], k, o, q, G, gen)
    scales = scales.to(torch.bfloat16)

    def call():
        return torch.cat(fn(x, packed, scales, g=G, out_dims=out_dims), dim=-1) if out_dims else fn(
            x, packed, scales, g=G)

    y = call()
    ref = plain(x, packed, scales, g=G)
    err = (y - ref).abs().max().item()
    same_bits = bool(torch.equal(call(), y))
    ok = bool(torch.allclose(y, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)) and bool(torch.isfinite(y).all()) and same_bits
    return dict(kernel=name, format=KERNELS[name][3], B=B, k=k, o=o, q=q, g=G, dtype="bfloat16",
                s_dtype="bfloat16", max_abs_err=err, tol=KERNEL_TOL, same_bits=same_bits, ok=ok)


def checked_shapes(records):
    """(kernel, planes, rows) of every bf16 leaf-shape check of phase 3."""
    return {(r["kernel"], r["q"], r["B"]) for r in records if r["leaf"] != "sweep" and is_bf16(r)}


def assert_checked(label, seen, checked):
    """Every (kernel, planes, rows) a counted run launched must have been
    held to its plain version in phase 3."""
    missing = sorted(set(seen) - checked)
    if missing:
        raise SystemExit(f"chip_smoke: [{label}] launched (kernel, planes, rows) {missing} that phase 3 never "
                         f"held to a plain version")


class _Counted:
    """A kernel wrapper seen through :func:`kernel_census`: counts each call
    by (kernel, planes, rows), then calls the wrapper. The wrapper counts its
    launches on its own module-level name, which now resolves here, so the
    counters pass through to the wrapper's."""

    def __init__(self, fn, name, seen):
        self._fn, self._name, self._seen = fn, name, seen

    def __call__(self, x, packed, scales, *a, **kw):
        self._seen[(self._name, packed.shape[0], x.shape[0])] += 1
        return self._fn(x, packed, scales, *a, **kw)

    def __getattr__(self, attr):  # launches, tc_launches, ...
        return getattr(self._fn, attr)

    def __setattr__(self, attr, value):
        if attr.startswith("_"):
            object.__setattr__(self, attr, value)
        else:
            setattr(self._fn, attr, value)


@contextlib.contextmanager
def kernel_census():
    """Count every K1, K2, K3 and K4 call by (kernel, planes, rows) while the
    block runs: the formats' ``matvec`` imports the wrapper at each call, so
    the module attribute patched here sees them all."""
    seen = collections.Counter()
    patched = []
    for name in ("bcq_mm", "bcq_mm_fused", "lutgemm", "ternary_mm"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        fn = getattr(mod, name)
        setattr(mod, name, _Counted(fn, name, seen))
        patched.append((mod, name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def forward_census(kernel_of, planes, rows, head_rows, n_layers, times=1):
    """The (kernel, planes, rows) calls of ``times`` forwards: each layer leaf
    once a layer at ``rows``, ``lm_head`` once at ``head_rows``."""
    c = collections.Counter()
    for leaf, kernel in kernel_of.items():
        c[(kernel, planes, head_rows if leaf == "lm_head" else rows)] += times * (1 if leaf == "lm_head" else n_layers)
    return c


def spec_paths(mode):
    """(target kernels, target planes, draft kernels, draft planes, SpecConfig)
    of each speculative path. "bcq q'=q" drafts with all q planes, so the
    draft is the target and every proposal must be accepted."""
    from repro_torch.infer import SpecConfig

    lut = dict.fromkeys(BCQ_LEAF_KERNELS, "lutgemm")
    return {
        "bcq": (BCQ_LEAF_KERNELS, Q, BCQ_LEAF_KERNELS, SPEC_Q, SpecConfig(SPEC_Q, SPEC_GAMMA)),
        "bcq q'=q": (BCQ_LEAF_KERNELS, Q, BCQ_LEAF_KERNELS, Q, SpecConfig(Q, SPEC_GAMMA)),
        "bcq lutgemm": (lut, Q, lut, SPEC_Q, SpecConfig(SPEC_Q, SPEC_GAMMA)),
        "ternary": (dict.fromkeys(BCQ_LEAF_KERNELS, "ternary_mm"), 2, BCQ_LEAF_KERNELS, SPEC_Q_TERNARY,
                    SpecConfig(SPEC_Q_TERNARY, SPEC_GAMMA)),
    }[mode]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def busy(run, wall_s):
    """Device busy ms of a profiled second run, and its share of the untraced run's wall."""
    device_ms, traced_ms, _ = device_profile(run)
    return dict(device_ms=device_ms, traced_wall_ms=traced_ms, busy_share=device_ms / (wall_s * 1e3))


def spec_generate_path(engine, prompts, path, checked):
    """Plain and speculative batched ``generate`` of the same prompts on one
    path: tokens equal, the speculative run's launches by (kernel, planes,
    rows) as the chunk structure predicts and each in ``checked`` (phase 3's
    shapes), K8 twice a layer (target and draft prefill), no ref-oracle
    dispatch; a q' = q draft must have every proposal accepted → summary."""
    import numpy as np

    from repro_torch.kernels import impl_mode

    kt, qt, kd, qd, spec = spec_paths(path)
    mode = "lutgemm" if path == "bcq lutgemm" else None
    L, B, n_tok = engine.cfg.n_layers, PROMPTS, PROMPTS * NEW_TOKENS
    with impl_mode(mode):
        engine.generate(prompts, 2, speculate=spec)  # warm-up: the draft view, allocator
        plain, t_plain = timed(lambda: engine.generate(prompts, NEW_TOKENS))
        _, ttft_plain = timed(lambda: engine.generate(prompts, 1))
        _, ttft_spec = timed(lambda: engine.generate(prompts, 1, speculate=spec))
        with kernel_census() as seen:
            res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS, speculate=spec))
        from repro_torch.kernels import ternary_mm
        tc_launches = ternary_mm.tc_launches
        st = res.spec_stats
        prof_spec = busy(lambda: engine.generate(prompts, NEW_TOKENS, speculate=spec), dt)
        prof_plain = busy(lambda: engine.generate(prompts, NEW_TOKENS), t_plain)
    chunks, S = st["chunks"], PROMPT_LEN
    expect = (forward_census(kt, qt, B * S, B, L) + forward_census(kd, qd, B * S, B, L)
              + forward_census(kd, qd, B, B, L, chunks * (spec.gamma + 1))
              + forward_census(kt, qt, B * (spec.gamma + 1), B * (spec.gamma + 1), L, chunks))
    same = int((res.tokens == plain.tokens).all(axis=1).sum())
    log(f"  [spec {path}] q'={spec.q_draft} γ={spec.gamma}: accept rate {st['accept_rate']:.3f} "
        f"({st['accepted']}/{st['proposed']}), {chunks} chunks; {dt:.3f}s, {n_tok / dt:.1f} tok/s "
        f"(plain {t_plain:.3f}s, {n_tok / t_plain:.1f} tok/s); TTFT {ttft_spec:.3f}s (plain {ttft_plain:.3f}s); "
        f"device busy {prof_spec['device_ms']:.2f} ms, {prof_spec['busy_share']:.1%} of the wall "
        f"(plain {prof_plain['device_ms']:.2f} ms, {prof_plain['busy_share']:.1%})")
    log(f"  [spec {path}] greedy rows identical to plain: {same}/{PROMPTS}; launches {json.dumps(counts)}, "
        f"ref-oracle dispatches {ref_calls}")
    if same != PROMPTS:
        raise SystemExit(f"chip_smoke: [spec {path}] speculative greedy tokens differ from plain greedy")
    if qd == qt and not (st["accept_rate"] == 1.0 and st["accepted"] == st["proposed"] > 0):
        raise SystemExit(f"chip_smoke: [spec {path}] the draft is the target, yet only {st['accepted']}/"
                         f"{st['proposed']} proposals were accepted: a verify row differs from a decode step")
    if ref_calls:
        raise SystemExit(f"chip_smoke: [spec {path}] took the ref oracle {ref_calls} times")
    if dict(seen) != dict(expect):
        raise SystemExit(f"chip_smoke: [spec {path}] launches by (kernel, planes, rows) {dict(seen)} != "
                         f"predicted {dict(expect)}")
    assert_checked(f"spec {path}", seen, checked)
    if counts["flash_attention"] != 2 * L:
        raise SystemExit(f"chip_smoke: [spec {path}] K8 launched {counts['flash_attention']} times, not {2 * L}")
    if tc_launches != counts["ternary_mm"]:
        raise SystemExit(f"chip_smoke: [spec {path}] K4 took its tensor cores {tc_launches} of "
                         f"{counts['ternary_mm']} times")
    log(f"  [spec {path}] launches by (kernel, planes, rows) as predicted: "
        + ", ".join(f"{k}:{q}:{r}={n}" for (k, q, r), n in sorted(seen.items())))
    return dict(spec_stats=st, wall_s=dt, tok_s=n_tok / dt, plain_wall_s=t_plain, plain_tok_s=n_tok / t_plain,
                ttft_s=ttft_spec, plain_ttft_s=ttft_plain, profile=prof_spec, plain_profile=prof_plain,
                census={f"{k}:{q}:{r}": n for (k, q, r), n in seen.items()}, launches=counts,
                tokens_equal=same)


def step_device_ms(engine, spec):
    """Device time (profiler, busy ms over 3 calls) of one draft decode step
    at q', one q = 4 decode step and one verify forward, B = 4 at position
    16 of a filled cache."""
    from repro_torch.models import forward

    cfg, B = engine.cfg, PROMPTS
    toks = torch.randint(0, cfg.vocab, (B, PROMPT_LEN + spec.gamma + 1), device=DEVICE)
    _, cache = engine.prefill(toks[:, :PROMPT_LEN], engine._make_cache(B))
    pos = torch.full((B,), PROMPT_LEN, device=DEVICE)
    draft = engine.draft_params(spec.q_draft)
    runs = {
        f"draft step q'={spec.q_draft}": lambda: forward(cfg, draft, tokens=toks[:, PROMPT_LEN : PROMPT_LEN + 1],
                                                        cache=cache, pos=pos, logits_mode="last"),
        f"decode step q={Q}": lambda: forward(cfg, engine.params, tokens=toks[:, PROMPT_LEN : PROMPT_LEN + 1],
                                              cache=cache, pos=pos, logits_mode="last"),
        f"verify forward q={Q}, {spec.gamma + 1} tokens": lambda: forward(
            cfg, engine.params, tokens=toks[:, PROMPT_LEN:], cache=cache, pos=pos, logits_mode="all",
            chunked_decode=True),
    }
    out = {}
    for name, fn in runs.items():
        fn()
        device_ms, traced_ms, _ = device_profile(lambda: [fn() for _ in range(3)])
        out[name] = dict(device_ms=device_ms / 3, wall_ms=traced_ms / 3)
    log(f"  [spec] device time a forward (B={B}, {cfg.n_layers} layers, profiler busy ms; traced wall in brackets): "
        + ", ".join(
        f"{name} {v['device_ms']:.3f} ms [{v['wall_ms']:.1f}]" for name, v in out.items()))
    return out


def spec_serving(serving, plain_summary, checked):
    """Phase 6's 12 requests through ``Scheduler(speculate=SpecConfig(2, 4))``
    with 4 slots; the temperature-1.0 requests opt out. Every greedy and
    opted-out request must equal phase 6's solo plain ``generate`` of it;
    sampled speculative ones are reported. Launches as in
    :func:`spec_generate_path`."""
    import numpy as np

    from repro_torch.infer import SpecConfig
    from repro_torch.launch.serve import drive_continuous

    engine, solos = serving["engine"], serving["solos"]
    spec = SpecConfig(SPEC_Q, SPEC_GAMMA)
    L, n, slots = engine.cfg.n_layers, len(SERVE_PROMPT_LENS), SERVE_SLOTS

    def requests(seed0):
        reqs = serve_requests(engine.cfg, SERVE_PROMPT_LENS, NEW_TOKENS, seed0)
        for r in reqs:
            r.speculate = r.temperature != 1.0
        return reqs

    def serve(seed0):
        reqs = requests(seed0)
        sched, done, wall = drive_continuous(engine, reqs, np.zeros(n), n_slots=slots, chunk=SPEC_CHUNK,
                                             speculate=spec)
        return reqs, sched, done, wall

    drive_continuous(engine, serve_requests(engine.cfg, (16, 40), 2, 900), np.zeros(2), n_slots=slots,
                     chunk=SPEC_CHUNK, speculate=spec)  # warm-up
    with kernel_census() as seen:
        (reqs, sched, done, wall), _, counts, ref_calls = run_counted(lambda: serve(200))
    summ = sched.summary()
    if len(done) != n or summ["by_state"] != {"finished": n}:
        raise SystemExit(f"chip_smoke: [spec continuous] not every request finished: {summ['by_state']}")
    by_rid = {c.rid: c.new_tokens for c in done}
    same = [bool(np.array_equal(by_rid[r.rid], o.tokens[0, r.prompt.size:])) for r, o in zip(reqs, solos)]
    held = [r.temperature == 0 or not r.speculate for r in reqs]
    dispatches = sched.decode_steps // SPEC_CHUNK
    kt, kd = BCQ_LEAF_KERNELS, BCQ_LEAF_KERNELS
    expect = collections.Counter()
    for r in reqs:
        expect += forward_census(kt, Q, r.prompt.size, 1, L) + forward_census(kd, SPEC_Q, r.prompt.size, 1, L)
    expect += forward_census(kd, SPEC_Q, slots, slots, L, dispatches * SPEC_CHUNK * (SPEC_GAMMA + 1))
    expect += forward_census(kt, Q, slots * (SPEC_GAMMA + 1), slots * (SPEC_GAMMA + 1), L, dispatches * SPEC_CHUNK)
    tok_s, ttft = n * NEW_TOKENS / wall, summ["ttft_s"]
    prof = busy(lambda: serve(300), wall)
    ptt = plain_summary["ttft_s"]
    log(f"  [spec continuous] {n} requests, {slots} slots, {SPEC_CHUNK} chunks a dispatch, q'={SPEC_Q} "
        f"γ={SPEC_GAMMA}: {wall:.3f}s, {tok_s:.1f} tok/s (plain, phase 6: {plain_summary['tok_s']:.1f}), "
        f"TTFT p50 {ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s (plain {ptt['p50']:.3f}s / {ptt['p95']:.3f}s), "
        f"draft acceptance ~{sched.spec_accept_rate:.3f}, {dispatches} dispatches; device busy "
        f"{prof['device_ms']:.2f} ms, {prof['busy_share']:.1%} of the wall (plain "
        f"{plain_summary['busy_share']:.1%})")
    log(f"  [spec continuous] greedy and opted-out requests == solo plain generate: "
        f"{sum(a for a, h in zip(same, held) if h)}/{sum(held)}; sampled speculative (reported, not asserted): "
        f"{sum(a for a, h in zip(same, held) if not h)}/{n - sum(held)} identical to the plain stream")
    log(f"  [spec continuous] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    if not all(a for a, h in zip(same, held) if h):
        raise SystemExit("chip_smoke: [spec continuous] a greedy or opted-out request differs from its solo generate")
    if ref_calls:
        raise SystemExit(f"chip_smoke: [spec continuous] took the ref oracle {ref_calls} times")
    if dict(seen) != dict(expect):
        raise SystemExit(f"chip_smoke: [spec continuous] launches by (kernel, planes, rows) {dict(seen)} != "
                         f"predicted {dict(expect)}")
    assert_checked("spec continuous", seen, checked)
    if counts["flash_attention"] != 2 * L * n:
        raise SystemExit(f"chip_smoke: [spec continuous] K8 launched {counts['flash_attention']} times, "
                         f"not {2 * L * n}")
    return dict(wall_s=wall, tok_s=tok_s, ttft_s=ttft, tpot_s=summ["tpot_s"], accept_rate=sched.spec_accept_rate,
                dispatches=dispatches, chunk_rows=sched.chunk_rows, held_same=same, profile=prof,
                plain_tok_s=plain_summary["tok_s"], plain_ttft_s=ptt, plain_busy_share=plain_summary["busy_share"],
                launches=counts)


def phase_speculative(bcq_engine, ternary_engine, prompts, serving, plain_continuous, checked):
    """Self-speculative decoding at full width and depth (module docstring,
    phase 7) → (summary, launches summed over its runs)."""
    out, launches, took = {}, collections.Counter(), {}
    for path, engine in (("bcq", bcq_engine), ("bcq lutgemm", bcq_engine), ("ternary", ternary_engine),
                         ("bcq q'=q", bcq_engine)):
        t0 = time.perf_counter()
        out[path] = spec_generate_path(engine, prompts, path, checked)
        launches.update(out[path]["launches"])
        took[path] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["steps"] = step_device_ms(bcq_engine, spec_paths("bcq")[4])
    took["steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["continuous"] = spec_serving(serving, plain_continuous, checked)
    launches.update(out["continuous"]["launches"])
    took["continuous"] = time.perf_counter() - t0
    log("  [spec] phase wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in took.items()))
    out["took_s"] = took
    return out, launches


def kernels_line(records, counts, n_layers, flash_records, spec_launches):
    """Per kernel: its launches in its path's counted run and, in bf16 at the
    batched decode width, its time summed over one decode step's launches;
    for K8, in bf16, its time summed over the L launches of one
    8192-token prefill (one launch a layer at B = 1, S = 8192). Kernels on
    the speculative path also carry ``spec_launches``, their launches summed
    over phase 7's counted runs."""
    out = []
    every_leaf = step_counts(n_layers)
    per_step = {"bcq_mm": {"wo": n_layers, "w_down": n_layers, "lm_head": 1},
                "bcq_mm_fused": {"wqkv": n_layers, "w_gate_up": n_layers}}
    for name, (src, replaces, _, _) in KERNELS.items():
        leaves = per_step.get(name, every_leaf)
        rs = [r for r in records if r["kernel"] == name]
        step = [(r, leaves[r["leaf"]]) for r in rs
                if r["leaf"] in leaves and r["B"] == PROMPTS and is_bf16(r)]
        total = lambda key: sum(r[key] * n for r, n in step)  # noqa: E731
        out.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
            launches=counts[name], max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=total("library_ms"),
        ))
        if name == "ternary_mm":
            out[-1]["tc_launches"] = counts["ternary_mm_tc"]
        out[-1]["spec_launches"] = spec_launches[name]
    H, Hkv, Dh = LLAMA_HEADS
    (r,) = [r for r in flash_records
            if (r["B"], r["S"], r["H"], r["Dh"], r["dtype"]) == (1, FLASH_S[-1], H, Dh, "bfloat16")]
    name, src, replaces = FLASH
    out.append(dict(
        name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
        launches=counts[name], max_abs_err=max(x["max_abs_err"] for x in flash_records),
        ms=r["ms"] * n_layers, plain_ms=r["plain_ms"] * n_layers, bound_ms=r["bound_ms"] * n_layers,
        bound_by=r["bound_by"], library_ms=r["library_ms"] * n_layers,
        spec_launches=spec_launches[name],
    ))
    return {"kernels": out}


def phase_wall(walls):
    """Log the wall seconds since the previous phase began."""
    now = time.perf_counter()
    log(f"  (phase wall {now - walls['t']:.1f}s)")
    walls["t"] = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls = {"t": time.perf_counter()}
    log("[1/8] card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), device {torch.cuda.get_device_name(0)}")

    phase_wall(walls)
    log("[2/8] build")
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f}s")
    for name in paths:  # ptxas -v: registers of every instantiation, and any spills
        regs, spills = [], []
        for line in _build.build_log(name).splitlines():
            line = line.strip()
            if "registers" in line:
                regs.append(int(line.split("Used ")[1].split(" registers")[0]))
            if "spill" in line and not line.startswith("0 bytes stack frame, 0 bytes spill stores"):
                spills.append(line)
        log(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{len(spills)} with stack or spills")
        for line in spills:
            log(f"    {line}")

    phase_wall(walls)
    log("[3/8] kernels against their plain versions")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    records = phase_kernels(gen)
    draft_records, draft_steps = draft_shapes(gen, records)
    limit_records = table_limit(gen)
    dense_rows = dense_rows_check(gen)

    phase_wall(walls)
    log("[4/8] flash_attention against its plain version")
    flash_records = phase_flash(gen)

    phase_wall(walls)
    log("[5/8] main path, one run per format")
    counts, cfg, summaries, bcq_engine, ternary_engine, prompts = phase_main_path()

    phase_wall(walls)
    log("[6/8] continuous serving and one long request")
    counts["flash_attention"], summaries["continuous"], serving = phase_serving(bcq_engine)
    summaries["long"] = phase_long(bcq_engine)

    phase_wall(walls)
    log("[7/8] self-speculative decoding")
    summaries["speculative"], spec_launches = phase_speculative(bcq_engine, ternary_engine, prompts, serving,
                                                                summaries["continuous"],
                                                                checked_shapes(records + draft_records))
    del bcq_engine, ternary_engine, serving

    phase_wall(walls)
    log("[8/8] kernels")
    line = kernels_line(records, counts, cfg.n_layers, flash_records, spec_launches)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "layers": cfg.n_layers, "records": records, "flash_records": flash_records,
         "steps": {path: {B: path_step(records, names, B, cfg.n_layers) for B in (1, PROMPTS, PROMPTS * PROMPT_LEN)}
                   for path, names in STEP_PATHS.items()},
         "table_limit": limit_records, "dense_rows": dense_rows,
         "draft_records": draft_records, "draft_steps": draft_steps,
         "paths": summaries, **line},
        indent=1))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
