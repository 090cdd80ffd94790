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
             each path's decode step at every q and B. Prompt rows (asserted):
             dense bf16 and ``dequant_mm`` rows of a 544-row prompt at
             ``wo`` and ``w_gate_up`` equal the same rows in a 32-row call
             (``utils.PROMPT_TILE``), and the tiles' cost on a dense bf16
             prefill of 512 and 8192 tokens, one product against tiles of 64
             and 128 rows;
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
             its time). bf16 runs on the tensor cores, f32 on the CUDA cores.
             The offset entry (queries at ``q_start``, keys a view of the
             first ``q_start + Sq`` rows of a cache whose later rows are NaN)
             at (q_start, Sq) = (512, 32), (7168, 1024), (384, 128) and (544,
             3), B = 1, bf16 and f32: against its plain version, each row bitwise equal to the
             same row of one cold launch over the whole sequence, the same
             bits on a rerun, read in place; timed beside SDPA with
             ``causal_lower_right``, its bound the larger of 4·H·Dh·Sq·
             (q_start + (Sq+1)/2) operations and the bytes of q, out and K/V
             rows [0, Sk);
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
             the ref oracle never. Decode steps replay a captured graph,
             whose launches the census adds once a replay from its capture's
             counts. Every capture is dumped (``CUDAGraph.debug_dump``) and
             its graph's kernel nodes must be, wrapper by wrapper, the
             launches its capture counted (K1 and K2 together: one device
             kernel; K4's tensor-core ones apart): ``inspect_captures``. A
             traced rerun of each path's batched ``generate`` must have the
             census of one such run, and its trace must show launches of
             every kernel the census counted and no more launches than it
             (a trace is a lower bound: the profiler drops records; the
             census counts one launch a row slab where a call is wider than
             a slab, ``grouptable.Plan.slab_rows``). Each path's logits are then held against
             the same engine under ``impl_mode("ref")``, and a reduced f32
             model per format against its oracle within the kernels'
             tolerance;
6. serving   the continuous-batching path on the bcq model: 12 requests of
             16 new tokens, prompts of 16 to 512 tokens (so K8 sees ragged
             S), greedy and sampled, through 4 slots with chunk 8. Every
             admission prefills through K8; greedy completions must equal a
             solo ``generate`` of each request, with the largest logit
             difference between a slot batch and solo forwards reported;
             tok/s, TTFT p50/p95 and the device's busy share are reported;
             the launches expected count one a row slab of each prompt's
             rows (``slab_launches``), and the profiled rerun's trace is
             held to the census as in phase 5.
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
8. prefix    the prefix cache and chunked prefill on the bcq model at 28
             layers: 12 requests sharing a 512-token system prompt, each
             with a 16-64-token tail and 16 new tokens (temperatures 0, 1.0,
             0.7), through 4 slots, chunk 8, after a warm-up of 6 of them on
             a cache of their own: a cold wave and an identical
             warm wave against one ``PrefixCache(block_tokens=16, max_bytes
             = 256 MB)`` with ``prefill_chunk=128``, then the same requests
             whole-shot without a cache. Every request's tokens and its
             last-prompt logits must be equal (bitwise) in all three, greedy
             ones equal to solo ``generate``, the warm wave must hit on every
             request, the accounting must be clean, and K8 must launch L
             times a prefill dispatch (offset ones counted apart); then each
             admission's device time cold against warm. Then phase 6's
             8192-token request through a 1-slot scheduler with
             ``prefill_chunk=1024`` (8 chunks, the last at q_start = 7168):
             tokens and last-prompt logits bitwise equal to phase 6's
             whole-shot run, its prefill time and peak memory beside it.
             What a cold wave costs: the cold wave, a cold wave with
             whole-shot admissions and the run without a cache, each again
             on a fresh cache, untraced and then traced (device busy share,
             device ms by part: K8, K1/K2, copies, the rest). Last, every
             shape the phase launched is held to its plain version: each
             (kernel, planes, rows, leaf) of K1/K2 that phase 3 did not
             check is checked, and each K8 (q_start, Sq) against its plain
             version and the rows of one cold launch;
9. kernels  one JSON line listing every kernel, its launches
             (``spec_launches``: on phase 7's runs; K8's ``offset_launches``:
             on phase 8's) and its numbers, printed last but one;
10. graphs   captured decode and the int8 cache, at 28 layers. Every
             format's batched ``generate`` of phase 5 (and bcq under
             ``impl_mode("lutgemm")``): 16 greedy decode steps replayed
             from the engine's decode graph (``infer/graphs.py``) against
             the eager loop, every step's logits bit for bit, then a sampled
             ``generate`` with the graph and with ``scan=False``, tokens and
             census equal; a traced rerun of each loop has its census and
             its trace shows every counted kernel, as in phase 5; each
             loop's wall, tok/s, device-busy share,
             kernel-wrapper launches and traced device events a step, and
             the graph's pool (the reserved memory its capture took, with
             the allocator's cache emptied first: ``inspect_captures``).
             Phase 6's 12 requests through 4 slots with the slot graph and
             with the eager slot loop (``engine._EAGER_SLOT_STEPS``): tokens
             and census equal, the same trace checks, wall, tok/s, TTFT and
             busy share of each. Then the int8 cache (``kv_cache_dtype="int8"``): the
             decode step's device time with the bf16 and the int8 cache at
             B = 64 and 4, ``max_seq`` 2048 (graph replays, median of 7),
             with the caches' and each capture's pool bytes; full-width int8 decode
             logits within 5% (relative L2, the reference's bound) of the
             bf16 cache's on the same tokens, prefill logits equal; greedy
             speculative == plain and slot == solo (12 requests, greedy and
             sampled) bit for bit; a warm prefix-cache admission and the
             8192-token request in 8 chunks, each within 5% of its cold
             whole-shot admission;
11. session  the async serving session (``launch/server.py::ServeSession``,
             driven in-process with asyncio: the card's machine has no
             aiohttp) on the bcq model at 28 layers, phase 6's 12 requests,
             4 slots, chunk 8, each session on a fresh slot state: observed
             (tracer on the engine and the scheduler, metrics registry) and
             unobserved, every stream bit for bit phase 6's solo
             ``generate``, the decode chunks replaying the slot graph
             captured on the pump thread, the launches as phase 6 expects
             them; the observed session's Chrome trace valid with all 12
             request lanes, ``counters_agree`` empty and the Prometheus
             ``kernel_launches_total`` equal to the census. One request
             cancelled at its first tokens (its budget 4x): the survivors
             exact. A warmed session (its graph captured before) profiled
             by ``torch.profiler`` started and stopped on the pump thread
             (``ServeSession.call_on_pump``), its first 2 requests, 8 new
             tokens each (a solo stream's first 8), the trace written to
             ``chiprun_out/serve_profile.json`` (~25 MB): every
             ``engine/*`` scope the run entered must be in it, and each
             scope's count, host ms and device ms (kernels by the
             correlation of their launch) are printed. Last, tok/s observed
             against unobserved, 3 warmed runs each, alternating, medians
             (printed, not bounded);
12. last line ``{"ok": true, "device": {...}}``.

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
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings
import weakref
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
# K8's offset entry (a prompt chunk, or a suffix after a cached prefix): (q_start, Sq) at B = 1
# (the first chunk, the last chunk of the 8192-token prompt) and two shapes of phase 8's:
# a 128-query chunk at a tile-aligned q_start and a 3-token warm suffix that straddles a key tile
FLASH_OFFSETS = ((512, 32), (7168, 1024), (384, 128), (544, 3))
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
LONG_CHUNK = 1024  # phase 8: the 8192-token request prefilled in chunks of this many tokens
# phase 8, the prefix cache: 12 requests share a system prompt of PREFIX_LEN
# tokens, each with its own tail of 16..64 tokens
PREFIX_LEN, PREFIX_BLOCK, PREFIX_CHUNK, PREFIX_CACHE_BYTES = 512, 16, 128, 256 << 20
PREFIX_TAILS = (16, 64, 23, 40, 31, 57, 18, 48, 35, 62, 27, 44)
# dense prompt rows (phase 3): the widths timed, and the row tiles compared
PROMPT_ROWS = (512, 8192)
PROMPT_TILES = (64, 128)
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
# part of the device kernel names each kernel wrapper launches, one kernel a
# call: K1 and K2 launch one kernel, grouptable_kernel over BCQGroups, so a
# trace holds their sum; K4 its tensor-core kernel or the group table over
# TernaryGroups; K8 either of its two kernels
TRACE_TAGS = {
    ("bcq_mm", "bcq_mm_fused"): ("BCQGroups",),
    ("lutgemm",): ("lutgemm_kernel",),
    ("uniform_mm",): ("UniformGroups",),
    ("dequant_materialize",): ("dequant_kernel",),
    ("ternary_mm",): ("ternary_tc_kernel", "TernaryGroups"),
    ("codebook_mm",): ("codebook_kernel",),
    ("flash_attention",): FLASH_TAGS,
}
L2_BYTES = 50 * 2**20
# phase 10: the decode step's device time with the bf16 and the int8 cache,
# at these widths (the widest first) and this cache length; int8
# logits within the reference's bound of the bf16 cache's
INT8_BATCHES, INT8_MAX_SEQ = (64, 4), 2048
INT8_REL_L2 = 5e-2  # tests/test_models.py::test_int8_kv_cache_decode_close_to_exact


# phase 11: the serving session's runs (each on a fresh slot state, so each
# captures its slot graph); the profiled window serves the first
# SESSION_PROFILED requests, PROFILED_NEW tokens each (one decode chunk):
# its Chrome trace holds ~2700 kernel events a decode step, ~0.8 KB each
# (4 requests of 16 tokens wrote 66.2 MB)
SESSION_OVERHEAD_RUNS, SESSION_PROFILED, PROFILED_NEW = 3, 2, SERVE_CHUNK
SESSION_CANCEL = 3  # the request cancelled mid-flight (index into phase 6's 12)
POOL_BYTES = weakref.WeakKeyDictionary()  # DecodeGraph → device memory its capture reserved
CAPTURE_THREADS = weakref.WeakKeyDictionary()  # DecodeGraph → the thread that captured it
GRAPH_NODES = weakref.WeakKeyDictionary()  # DecodeGraph → {wrapper group: kernel nodes in its CUDA graph}
GRAPH_DIR = ROOT / "chiprun_out" / "graphs"  # a graph's DOT dump, kept where it disagrees


def graph_kernel_nodes(dot):
    """{wrapper group (``TRACE_TAGS``): kernel nodes} of a CUDA graph's DOT
    dump (``cudaGraphDebugDotPrint``), each node statement counted once by
    the kernel name it holds; K4's tensor-core nodes also apart."""
    stmts = re.split(r'(?m)^(?=\s*"[^"\n]+"\s*\[)', dot)[1:]
    nodes = {"+".join(group): sum(any(tag in st for tag in tags) for st in stmts)
             for group, tags in TRACE_TAGS.items()}
    nodes["ternary_mm on the tensor cores"] = sum("ternary_tc_kernel" in st for st in stmts)
    return nodes


def capture_counts(graph):
    """{wrapper group: launches} a decode graph's capture counted (the counts
    each replay adds), in ``graph_kernel_nodes``'s keys."""
    from repro_torch.kernels import COUNTERS

    delta = {(obj.__name__, attr): d for (obj, attr), d in zip(COUNTERS, graph.delta)}
    out = {"+".join(group): sum(delta[(w, "launches")] for w in group) for group in TRACE_TAGS}
    out["ternary_mm on the tensor cores"] = delta[("ternary_mm", "tc_launches")]
    return out


def inspect_captures():
    """From here on every decode-graph capture (``infer/graphs.py``) is
    checked and measured. Its CUDA graph is made in debug mode and dumped
    (DOT): the kernel nodes it recorded must be, wrapper by wrapper, the
    launches its capture counted, which every replay adds to the census
    (a replay runs every node of its graph; at decode widths a call is one
    launch, never a row slab's several). And ``POOL_BYTES`` records the
    device memory the capture reserved: the allocator's cache emptied
    first, reserved bytes after the capture less before it. Checks and
    measurements of this script's, kept out of the serving path."""
    from repro_torch.infer.graphs import DecodeGraph

    real, Graph = DecodeGraph._capture, torch.cuda.CUDAGraph
    kept = []  # whether the graph being captured keeps its cudaGraph_t (keep_graph)

    def debug_graph():
        try:
            g = Graph(keep_graph=True)
            kept.append(True)
        except TypeError:  # a torch without keep_graph keeps it in debug mode
            g = Graph()
            kept.append(False)
        g.enable_debug_mode()
        return g

    def inspected(graph):
        CAPTURE_THREADS[graph] = threading.current_thread().name
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        kept.clear()
        torch.cuda.CUDAGraph = debug_graph
        try:
            real(graph)
        finally:
            torch.cuda.CUDAGraph = Graph
        if kept[0]:
            graph.graph.instantiate()
        POOL_BYTES[graph] = torch.cuda.memory_reserved() - before
        GRAPH_DIR.mkdir(parents=True, exist_ok=True)
        path = GRAPH_DIR / f"graph-{id(graph):x}.dot"
        with warnings.catch_warnings():  # debug_dump warns that it is a debugging call
            warnings.simplefilter("ignore")
            graph.graph.debug_dump(str(path))
        if not path.is_file():
            raise SystemExit(f"chip_smoke: CUDAGraph.debug_dump wrote no {path} (torch {torch.__version__})")
        nodes, counted = graph_kernel_nodes(path.read_text()), capture_counts(graph)
        if nodes != counted:
            raise SystemExit(f"chip_smoke: a decode graph (B = {graph.batch}, impl mode {graph.mode}) recorded "
                             f"kernel nodes {nodes}, its capture counted {counted} (dump: {path})")
        path.unlink()
        GRAPH_NODES[graph] = nodes

    DecodeGraph._capture = inspected


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


def prompt_tiles_check(gen):
    """Prompt rows (``utils.PROMPT_TILE``), asserted: a dense bf16
    product (``utils.matmul_rows``) and ``dequant_mm`` of a 544-row prompt
    at ``wo`` and ``w_gate_up`` give its rows the bits of the same rows in a
    32-row call (a chunk or a warm suffix), tile-aligned or not; tolerance
    0. Then the cost, on a dense bf16 prefill of 512 and 8192 tokens: the
    four layer leaves at those rows as one product, and in tiles of 64 and
    of 128 rows, summed over 28 layers → dict."""
    from repro_torch.kernels import dequant_mm
    from repro_torch.utils import PROMPT_TILE, matmul_row_tiles, matmul_rows

    checks = []
    for leaf in ("wo", "w_gate_up"):
        k, o, _ = LEAVES[leaf]
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        packed, scales = format_planes("dequant", k, o, Q, G, gen)
        scales = scales.to(torch.bfloat16)
        x = torch.randn((1, 544, k), generator=gen, device=DEVICE).to(torch.bfloat16)
        full, dfull = matmul_rows(x, w16), dequant_mm(x[0], packed, scales, g=G)
        for start in (512, 500, 77):
            part = x[:, start : start + 32]
            dense_ok = torch.equal(matmul_rows(part, w16), full[:, start : start + 32])
            deq_ok = torch.equal(dequant_mm(part[0], packed, scales, g=G), dfull[start : start + 32])
            checks.append(dict(leaf=leaf, start=start, dense=dense_ok, dequant=deq_ok))
            log(f"  prompt rows {start}..{start + 31} of 544 at {leaf:9s} in a 32-row call (tiles of "
                f"{PROMPT_TILE}): dense bf16 {'equal' if dense_ok else 'DIFFER'}, dequant_mm "
                f"{'equal' if deq_ok else 'DIFFER'} (tolerance 0)")
    if not all(c["dense"] and c["dequant"] for c in checks):
        raise SystemExit(f"chip_smoke: prompt rows differ by the call they are in: {checks}")

    costs = []
    for leaf in ("wqkv", "wo", "w_gate_up", "w_down"):
        k, o, _ = LEAVES[leaf]
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        ws = [(w16,)] + [(w16.clone(),) for _ in range(n_copies(w16.numel() * 2) - 1)]
        for S in PROMPT_ROWS:
            x = torch.randn((S, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            rec = dict(leaf=leaf, S=S, one_ms=time_ms(lambda w: torch.matmul(x, w), ws))
            for tile in PROMPT_TILES:
                rec[f"tile{tile}_ms"] = time_ms(lambda w, t=tile: matmul_row_tiles(x, w, t), ws)
            costs.append(rec)
        del ws, w16
    forward = {}
    for S in PROMPT_ROWS:
        keys = ["one_ms"] + [f"tile{t}_ms" for t in PROMPT_TILES]
        forward[S] = {key: 28 * sum(r[key] for r in costs if r["S"] == S) for key in keys}
        f = forward[S]
        log(f"  dense bf16 prefill of {S} tokens, the four layer leaves over 28 layers: one product "
            f"{f['one_ms']:.3f} ms; " + ", ".join(
                f"tiles of {t} {f[f'tile{t}_ms']:.3f} ms ({f[f'tile{t}_ms'] / f['one_ms'] - 1:+.1%})"
                for t in PROMPT_TILES) + f"; utils.PROMPT_TILE = {PROMPT_TILE}")
    return dict(checks=checks, costs=costs, forward=forward)


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


def sdpa_lower_right(q, k, v):
    """The library yardstick of the offset entry: one fused PyTorch attention
    call with the causal mask aligned to the last key
    (``torch.nn.attention.bias.causal_lower_right``). Timed only."""
    from torch.nn.attention.bias import causal_lower_right

    mask = causal_lower_right(q.shape[1], k.shape[1])
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
    ).transpose(1, 2)


def flash_offset_inputs(q_start, sq, dtype, gen, B=1):
    """Inputs of K8's offset entry at llama3.2-3b's heads: the queries of the
    whole sequence ``(B, Sk, H, Dh)`` and a K/V cache ``(2, B, Sk + 64,
    Hkv, Dh)`` whose rows past ``Sk = q_start + Sq`` hold NaN."""
    H, Hkv, Dh = LLAMA_HEADS
    sk = q_start + sq
    q_all = torch.randn((B, sk, H, Dh), generator=gen, device=DEVICE).to(dtype)
    cache = torch.full((2, B, sk + 64, Hkv, Dh), float("nan"), device=DEVICE, dtype=dtype)
    cache[:, :, :sk] = torch.randn((2, B, sk, Hkv, Dh), generator=gen, device=DEVICE).to(dtype)
    return q_all, cache


def flash_offset_verdict(q_all, cache, q_start, sq):
    """K8's offset entry on :func:`flash_offset_inputs`: queries ``q_all[:,
    q_start:]`` over the views ``cache[:, :, :q_start + Sq]``, against its
    plain version (the tolerances of :func:`check_flash`), each row against
    the same row of one cold launch over the whole sequence (bitwise), a
    rerun (bitwise), read in place → record."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attn import BF16_ROW_TOL, row_rel_err

    H, Hkv, Dh = LLAMA_HEADS
    dtype, sk = q_all.dtype, q_start + sq
    q, k, v = q_all[:, q_start:], cache[0, :, :sk], cache[1, :, :sk]
    copies0 = flash_attention.copies
    out = flash_attention(q, k, v, q_start)
    torch.cuda.synchronize()
    plain = flash_attention_plain(q, k, v, q_start)
    err = (out.float() - plain.float()).abs().max().item()
    row_err = row_rel_err(out, plain)
    tol = FLASH_TOL[dtype]
    within = bool(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol))
    del plain
    cold = flash_attention(q_all, k.contiguous(), v.contiguous())[:, q_start:]
    rows_equal = bool(torch.equal(out, cold))
    same_bits = bool(torch.equal(flash_attention(q, k, v, q_start), out))
    in_place = flash_attention.copies == copies0
    row_tol = BF16_ROW_TOL if dtype == torch.bfloat16 else None
    ok = (within and (row_tol is None or row_err <= row_tol) and rows_equal and same_bits and in_place
          and bool(torch.isfinite(out).all()))
    return dict(kernel=FLASH[0], B=q_all.shape[0], q_start=q_start, Sq=sq, Sk=sk, H=H, Hkv=Hkv, Dh=Dh,
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=tol, row_rel_err=row_err,
                row_tol=row_tol, rows_equal_cold=rows_equal, same_bits=same_bits, in_place=in_place, ok=ok)


def check_flash_offset(q_start, sq, dtype, gen):
    """K8's offset entry at llama3.2-3b's heads, B = 1, checked as in
    :func:`flash_offset_verdict`, then timed beside ``sdpa_lower_right``
    → record."""
    from repro_torch.kernels import flash_attention, flash_attention_plain

    H, Hkv, Dh = LLAMA_HEADS
    sk = q_start + sq
    size = 4 if dtype == torch.float32 else 2
    nbytes = (2 * sq * H * Dh + 2 * sk * Hkv * Dh) * size  # q and out; K/V rows [0, Sk)
    sets = [flash_offset_inputs(q_start, sq, dtype, gen) for _ in range(n_copies(nbytes))]
    inputs = [(q_all[:, q_start:], cache[0, :, :sk], cache[1, :, :sk]) for q_all, cache in sets]
    rec = flash_offset_verdict(*sets[0], q_start, sq)
    err, row_err = rec["max_abs_err"], rec["row_rel_err"]
    rows_equal, same_bits, in_place, ok = rec["rows_equal_cold"], rec["same_bits"], rec["in_place"], rec["ok"]
    ms = time_ms(lambda q, k, v: flash_attention(q, k, v, q_start), inputs)
    plain_ms = time_ms(lambda q, k, v: flash_attention_plain(q, k, v, q_start), inputs[:1], reps=3, inner=1)
    library_ms = None
    if dtype == torch.bfloat16:
        try:
            library_ms = time_ms(sdpa_lower_right, inputs)
        except RuntimeError as e:  # the yardstick only: time it on K/V heads repeated instead
            log(f"  (SDPA with causal_lower_right refused enable_gqa: {str(e)[:200]}; timed with the K/V "
                f"heads repeated {H // Hkv}x)")
            wide = [(a, b.repeat_interleave(H // Hkv, 2), c.repeat_interleave(H // Hkv, 2)) for a, b, c in inputs]
            library_ms = time_ms(sdpa_lower_right, wide)
    ops = 4.0 * H * Dh * sq * (q_start + (sq + 1) / 2)
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
               bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    lib = "-" if library_ms is None else f"{library_ms:.4f}"
    log(f"  flash_attention offset q_start={q_start:<5d} Sq={sq:<5d} Sk={sk:<5d} {rec['dtype']:8s} err {err:.2e} "
        f"row {row_err:.2e} rows == cold launch {'yes' if rows_equal else 'NO'} bits "
        f"{'same' if same_bits else 'DIFFER'} in place {'yes' if in_place else 'NO'} {'ok' if ok else 'FAIL'}  "
        f"ms {ms:.4f} = {ms / rec['bound_ms']:.1f}x bound {rec['bound_ms']:.4f} ({rec['bound_by']})  plain "
        f"{plain_ms:.4f}  library (causal_lower_right SDPA) {lib}")
    return rec


def phase_flash(gen):
    H, Hkv, Dh = LLAMA_HEADS
    shapes = [(B, S, H, Hkv, Dh) for B in (1, PROMPTS) for S in FLASH_S] + FLASH_EXTRA
    records = [check_flash(*shape, dtype, gen) for shape in shapes
               for dtype in (torch.bfloat16, torch.float32)]
    offsets = [check_flash_offset(q_start, sq, dtype, gen) for q_start, sq in FLASH_OFFSETS
               for dtype in (torch.bfloat16, torch.float32)]
    bad = [r for r in records + offsets if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} flash_attention checks disagree with the plain version: {bad[:3]}")
    return records, offsets


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
                   profile=profile_generate(engine, prompts, t_batched, "bcq", dict(
                       dict.fromkeys(counts, 0), bcq_mm=forwards * (2 * L + 1), bcq_mm_fused=forwards * 2 * L,
                       flash_attention=L)))
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
                   tc_launches=tc_launches, profile=profile_generate(engine, prompts, dt, fmt, counts))
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
    counts, summary, bcq = serve_bcq(cfg, params, prompts, reqs)
    engines = {"bcq": bcq}  # every format's engine: phase 7 speculates on ternary, phase 10 replays all
    summaries = {"bcq": summary}
    tokens = {}
    for fmt, kernel in FORMAT_KERNEL.items():
        counts[kernel], tokens[fmt], summaries[fmt], engines[fmt] = serve_format(cfg, params, prompts, fmt)
    counts["ternary_mm_tc"] = summaries["ternary"]["tc_launches"]
    same = int((tokens["uniform"] == tokens["dequant"]).all(axis=1).sum())
    log(f"  greedy rows identical, uniform vs dequant: {same}/{PROMPTS} (reported, not asserted: "
        f"the two kernels sum k in different orders)")
    log(f"  K8 inputs copied for the TMA's alignment on the main path: {flash_attention.copies}")
    if flash_attention.copies:
        raise SystemExit("chip_smoke: the model's q, k, v views did not reach K8 in place")
    return counts, cfg, summaries, engines, prompts


def serving_engine(engine, max_seq, prefix_cache=None, tracer=None):
    """The bcq engine's fused weights behind another cache length (no copy),
    with ``prefix_cache`` and ``tracer`` if given."""
    from repro_torch.infer import Engine

    return Engine(engine.cfg, engine.params, max_seq=max_seq, fuse=False, device="cuda",
                  prefix_cache=prefix_cache, tracer=tracer)


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


def slab_launches(leaf, rows, q=Q):
    """K1/K2 launches of one call of ``rows`` rows at ``leaf``: one a row slab
    (``grouptable.Plan.slab_rows``; decode widths take one)."""
    from repro_torch.kernels import grouptable

    k, o, _ = LEAVES[leaf]
    return -(-rows // grouptable.plan("bcq", k, o, q, G, torch.bfloat16, torch.bfloat16).slab_rows(rows))


def expect_forward_counts(counts, decode_steps, prompt_rows, n_layers, decode_rows=SERVE_SLOTS):
    """Launch counts of the bcq path over ``decode_steps`` decode forwards of
    ``decode_rows`` rows and one prefill of ``r`` rows for each ``r`` in
    ``prompt_rows`` (its ``lm_head`` at its last row; K8 once a layer): each
    call wider than a row slab launches once a slab (:func:`slab_launches`)."""
    expect = dict.fromkeys(counts, 0)
    forwards = [(decode_rows, decode_rows)] * decode_steps + [(r, 1) for r in prompt_rows]
    expect.update(
        bcq_mm=sum(n_layers * (slab_launches("wo", r) + slab_launches("w_down", r)) + slab_launches("lm_head", h)
                   for r, h in forwards),
        bcq_mm_fused=sum(n_layers * (slab_launches("wqkv", r) + slab_launches("w_gate_up", r)) for r, _ in forwards),
        flash_attention=len(prompt_rows) * n_layers)
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


def device_profile(run, cross_check=False, events=False):
    """Device busy time by kernel over ``run()``, traced with
    ``torch.profiler`` (CUDA activity only, which slows the host least) →
    (device ms, traced wall ms, {kernel: ms}). The device activities are
    summed straight from the trace's events (``kineto_results``, a private
    attribute, checked on torch 2.11): ``key_averages()`` builds a Python
    object per event (~70 us each), a minute for the ~10^5 kernels of a
    speculative run. Without that attribute the sum falls back to
    ``key_averages()``; ``cross_check`` computes both and fails unless they
    agree within 0.1% plus a microsecond an event (the rounding of the
    public sum). ``events``: also return the trace's device events by name
    ({kernel, copy or memset: how many ran}), which a CUDA graph's replay
    shows one by one as an eager launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    fast = _trace_device_ms(prof)
    if fast is None or cross_check:
        public, public_n = {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                public[ev.key] = public.get(ev.key, 0.0) + us / 1e3
                public_n[ev.key] = public_n.get(ev.key, 0) + ev.count
        if fast is None:
            fast = (public_n, public)
        else:
            n_events, a, b = sum(fast[0].values()), sum(fast[1].values()), sum(public.values())
            log(f"  device_profile cross-check (torch {torch.__version__}): trace events {a:.3f} ms over "
                f"{n_events} events, key_averages() {b:.3f} ms")
            if abs(a - b) > 1e-3 * b + 1e-3 * n_events:
                raise SystemExit(f"chip_smoke: the trace's device events sum to {a:.3f} ms, key_averages() to "
                                 f"{b:.3f} ms: the profiler's private event list changed meaning")
    counts, by_name = fast
    result = (sum(by_name.values()), traced_ms, by_name)
    return (*result, counts) if events else result


def _trace_device_ms(prof):
    """({kernel: events}, {kernel: ms}) of the trace's device activities, or
    None where this torch has no ``kineto_results`` event list."""
    try:
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
    except (AttributeError, ImportError):
        return None
    by_name, counts = {}, {}
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
            counts[ev.name()] = counts.get(ev.name(), 0) + 1
    return counts, by_name


def traced_launches(by_count):
    """{kernel-wrapper group: device launches in a trace} (``TRACE_TAGS``)."""
    return {"+".join(group): sum(n for name, n in by_count.items() if any(tag in name for tag in tags))
            for group, tags in TRACE_TAGS.items()}


def check_trace_census(label, by_count, counts, tc_launches=None):
    """A run's launch census (``counts``: what the wrappers counted, each
    graph replay adding its capture's counts, which ``inspect_captures``
    holds to the graph's kernel nodes) beside the kernels its profiler trace
    saw run on the card, wrapper by wrapper (K1 and K2 as one: they launch
    one device kernel); with ``tc_launches``, K4's tensor-core launches too.
    The census counts launches, one a row slab where a call is wider than a
    slab (``grouptable.Plan.slab_rows``: prompt rows of a long admission).
    The profiler drops device records (on an H100 with torch 2.11, up to 43
    of a run's ~1900 launches of one kernel, none in most runs), so a trace
    is a lower bound. This fails where a trace holds more launches of a
    wrapper's kernel than the census counted, or none of one it counted →
    (traced launches, census less traced)."""
    traced = traced_launches(by_count)
    census = {"+".join(group): sum(counts[w] for w in group) for group in TRACE_TAGS}
    if tc_launches is not None:
        traced["ternary_mm on the tensor cores"] = sum(n for name, n in by_count.items() if "ternary_tc_kernel" in name)
        census["ternary_mm on the tensor cores"] = tc_launches
    if any(census[k] and not traced[k] for k in census):
        raise SystemExit(f"chip_smoke: [{label}] the trace holds no launch of a kernel the census counted: "
                         f"traced {traced}, census {census}")
    if any(traced[k] > census[k] for k in census):
        raise SystemExit(f"chip_smoke: [{label}] the trace holds more launches than the census counted: "
                         f"traced {traced}, census {census}")
    return traced, {k: census[k] - traced[k] for k in census if census[k] != traced[k]}


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
    expect = expect_forward_counts(counts, sched.decode_steps, [r.prompt.size for r in reqs], L)
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

    (device_ms, traced_ms, by_name, by_count), _, traced_counts, _ = run_counted(
        lambda: device_profile(lambda: serve(300), events=True))
    traced, missed = check_trace_census("continuous", by_count, traced_counts)
    log(f"  [continuous] the traced run's launches by kernel {traced}; the census less the traced "
        f"{missed or 0} (the profiler drops records: a trace is a lower bound)")
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
                   top=[[k, v] for k, v in top], traced_launches=traced, census_less_traced=missed)
    return counts["flash_attention"], summary, dict(engine=engine, solos=solos)


def synced_clock():
    """A lifecycle clock whose stamps include the device's work."""
    torch.cuda.synchronize()
    return time.perf_counter()


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
    oracle, so the logits are compared on the same inputs → (summary, the
    whole-shot kernel path's last-prompt logits, its tokens)."""
    import numpy as np

    from repro_torch.infer import RequestState, Scheduler
    from repro_torch.kernels import impl_mode
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = bcq_engine.cfg
    L, S = cfg.n_layers, LONG_SEQ_THRESHOLD
    engine = serving_engine(bcq_engine, S + LONG_NEW)
    (req,) = serve_requests(cfg, (S,), LONG_NEW, 500)  # greedy

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
    expect = expect_forward_counts(counts, steps, [S], L, decode_rows=1)
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
    summary = dict(prompt_len=S, new_tokens=LONG_NEW, wall_s=wall, prefill_s=prefill_s, peak_gb=peak / 1e9,
                   base_gb=base / 1e9, sdpa_logits_gb_per_layer=logits_gb, ref_prefill_s=rprefill_s,
                   ref_peak_gb=rpeak / 1e9, tokens_identical=same, tokens=toks.tolist(), ref_tokens=rtoks.tolist(),
                   rel_kernel_ref=rel_kr, rel_kernel_f32=rel_kf, rel_ref_f32=rel_rf, margins=margin,
                   max_abs_diff=diff, top1_kernel_ref=agree(kl, rl), top1_kernel_f32=agree(kl, fl),
                   top1_ref_f32=agree(rl, fl))
    return summary, kl[0].clone(), toks


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


def profile_generate(engine, prompts, untraced_s, fmt, expect):
    """Device busy time by kernel over one batched ``generate``, its decode
    steps replays of the engine's graph (captured beforehand, outside the
    trace). Its launch census must equal ``expect`` (one such ``generate``'s
    counts) and the kernels the trace saw run (:func:`check_trace_census`)."""
    from repro_torch.kernels import ternary_mm

    engine.generate(prompts, 2)  # this width's graph under this impl mode, captured
    (device_ms, traced_ms, by_name, by_count), _, counts, _ = run_counted(
        lambda: device_profile(lambda: engine.generate(prompts, NEW_TOKENS), cross_check=fmt == "bcq", events=True))
    if counts != expect:
        raise SystemExit(f"chip_smoke: [{fmt}] the traced generate's census {counts} != expected {expect}")
    traced, missed = check_trace_census(f"{fmt} generate", by_count, counts, ternary_mm.tc_launches)
    ours_ms = sum(ms for name, ms in by_name.items() if PROFILE_TAG[fmt] in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  [{fmt}] profile of one batched generate: device busy {device_ms:.2f} ms of "
        f"{traced_ms:.2f} ms traced wall ({device_ms / traced_ms:.1%}; untraced wall "
        f"{untraced_s * 1e3:.2f} ms, busy {device_ms / (untraced_s * 1e3):.1%} of it), the format's "
        f"kernels {ours_ms:.2f} ms; kernel launches in the trace {({k: v for k, v in traced.items() if v})}, "
        f"the census less these {missed or 0}")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    return dict(device_ms=device_ms, traced_wall_ms=traced_ms, untraced_wall_ms=untraced_s * 1e3,
                format_kernels_ms=ours_ms, top=[[name, ms] for name, ms in top], traced_launches=traced,
                census_less_traced=missed)


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

    def __init__(self, fn, name, seen, by_leaf):
        self._fn, self._name, self._seen, self._by_leaf = fn, name, seen, by_leaf

    def __call__(self, x, packed, scales, *a, **kw):
        leaf = (x.shape[-1], packed.shape[-1]) if self._by_leaf else ()
        self._seen[(self._name, packed.shape[0], x.shape[0], *leaf)] += 1
        return self._fn(x, packed, scales, *a, **kw)

    def __getattr__(self, attr):  # launches, tc_launches, ...
        return getattr(self._fn, attr)

    def __setattr__(self, attr, value):
        if attr.startswith("_"):
            object.__setattr__(self, attr, value)
        else:
            setattr(self._fn, attr, value)


@contextlib.contextmanager
def kernel_census(by_leaf=False):
    """Count every K1, K2, K3 and K4 call by (kernel, planes, rows) while the
    block runs (``by_leaf``: by (kernel, planes, rows, k, o)): the formats'
    ``matvec`` imports the wrapper at each call, so the module attribute
    patched here sees them all."""
    seen = collections.Counter()
    patched = []
    for name in ("bcq_mm", "bcq_mm_fused", "lutgemm", "ternary_mm"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        fn = getattr(mod, name)
        setattr(mod, name, _Counted(fn, name, seen, by_leaf))
        patched.append((mod, name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


@contextlib.contextmanager
def flash_census():
    """Count every K8 call of the model by (B, q_start, Sq, dtype) while the
    block runs: ``models.layers`` holds the wrapper under its own name, which
    is patched here."""
    from repro_torch.models import layers

    seen = collections.Counter()
    real = layers.flash_attention

    def counted(q, k, v, q_start=0):
        seen[(q.shape[0], q_start, q.shape[1], q.dtype)] += 1
        return real(q, k, v, q_start)

    layers.flash_attention = counted
    try:
        yield seen
    finally:
        layers.flash_attention = real


def check_launched(label, seen, attn, records, gen):
    """Hold every shape a phase launched to its plain version: each (kernel,
    planes, rows, k, o) of ``seen`` (:func:`kernel_census` by leaf) that
    phase 3's ``records`` did not check at that leaf, through
    :func:`check_untimed`, and each K8 (B, q_start, Sq, dtype) of ``attn``
    (:func:`flash_census`) through :func:`flash_offset_verdict` (plain
    version, rows of the cold launch, rerun) → records."""
    if not (seen and attn):
        raise SystemExit(f"chip_smoke: [{label}] the census saw no launches (K1-K4: {len(seen)}, K8: {len(attn)})")
    done = {(r["kernel"], r["q"], r["B"], r["k"], r["o"]) for r in records if r["leaf"] != "sweep" and is_bf16(r)}
    leaf_of = {(k, o): (leaf, dims) for leaf, (k, o, dims) in LEAVES.items()}
    recs = []
    for name, q, rows, k, o in sorted(set(seen) - done):
        leaf, dims = leaf_of[(k, o)]
        rec = check_untimed(name, rows, k, o, q, gen, dims if name == "bcq_mm_fused" else None)
        rec["leaf"] = leaf
        recs.append(rec)
    flash = [flash_offset_verdict(*flash_offset_inputs(q_start, sq, dtype, gen, B), q_start, sq)
             for B, q_start, sq, dtype in sorted(attn, key=lambda t: (t[0], t[1], t[2], str(t[3])))]
    bad = [r for r in recs + flash if not r["ok"]]
    rows = sorted({r["B"] for r in recs})
    log(f"  [{label}] launched shapes held to their plain versions: {len(set(seen))} (kernel, planes, rows, leaf) "
        f"of K1-K4, {len(set(seen) - done)} of them not checked in phase 3 and checked now (rows {rows}); "
        f"{len(flash)} K8 (B, q_start, Sq) shapes (q_start {sorted({r['q_start'] for r in flash})}, Sq "
        f"{sorted({r['Sq'] for r in flash})}), largest K8 error {max((r['max_abs_err'] for r in flash), default=0):.2e}"
        f": {len(bad)} disagree")
    if bad:
        raise SystemExit(f"chip_smoke: [{label}] {len(bad)} launched shapes disagree with their plain versions: "
                         f"{bad[:3]}")
    return recs + flash


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


def prompt_key(prompt):
    """A prompt's token ids (host array or device tensor) as a dict key."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.cpu().numpy()
    return tuple(int(t) for t in prompt.reshape(-1))


def record_admissions(engine):
    """Keep the last-prompt logits of every admission the engine finishes,
    keyed by :func:`prompt_key` (patches ``finish_admission`` on the
    instance; ``admit_slot`` goes through it too). Undo with
    ``del engine.finish_admission``."""
    seen = {}
    real = engine.finish_admission

    def finish(slots, slot, pending):
        out = real(slots, slot, pending)
        seen[prompt_key(pending.prompt)] = out["logits"][slot].clone()
        return out

    engine.finish_admission = finish
    return seen


def prefix_requests(cfg):
    """12 requests sharing a ``PREFIX_LEN``-token system prompt, each with
    its own tail (``PREFIX_TAILS``); temperatures cycle 0, 1.0, 0.7."""
    import numpy as np

    from repro_torch.data import MarkovCorpus
    from repro_torch.infer import Request

    corpus = MarkovCorpus(cfg.vocab, seed=3)
    shared = corpus.sample(1, PREFIX_LEN, seed=99)[0, :PREFIX_LEN]
    return [
        Request(prompt=np.concatenate([shared, corpus.sample(1, t, seed=600 + i)[0, :t]]).astype(np.int32),
                max_new_tokens=NEW_TOKENS, temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
        for i, t in enumerate(PREFIX_TAILS)
    ]


def chunk_launches(sched, reqs, chunk):
    """The rows of each prefill dispatch of a scheduler run's admissions (one
    K8 launch a layer each: whole-shot, the prompt; chunked, the uncached
    rows in pieces of ``chunk``), and how many of them start at
    ``q_start > 0`` (offset unless the dispatch starts at 0)."""
    rows, offset = [], 0
    for r in reqs:
        rec = sched.outcomes[r.rid]
        todo = r.prompt.size - rec.prefix_hit_tokens
        n = 1 if chunk is None else -(-todo // chunk)
        if rec.prefill_chunks != n:
            raise SystemExit(f"chip_smoke: [prefix] request {r.rid} took {rec.prefill_chunks} prefill "
                             f"dispatches, not {n}")
        rows += [todo] if chunk is None else [min(chunk, todo - i * chunk) for i in range(n)]
        offset += n if rec.prefix_hit_tokens else n - 1
    return rows, offset


def phase_prefix(bcq_engine, long_whole, records, gen):
    """The prefix cache and chunked prefill at full width and depth
    (module docstring, phase 8), every shape it launched then held to its
    plain version (``records``: phase 3's) → summary."""
    with kernel_census(by_leaf=True) as seen, flash_census() as attn:
        out = prefix_runs(bcq_engine, long_whole)
    out["launched_checks"] = check_launched("prefix", seen, attn, records, gen)
    return out


def device_split(by_name):
    """A trace's device ms by part: K8, K1/K2, copies (copy kernels, cat,
    memcpy, memset) and the rest."""
    parts = dict.fromkeys(("K8", "K1/K2", "copies", "other"), 0.0)
    for name, ms in by_name.items():
        low = name.lower()
        part = ("K8" if any(t in name for t in FLASH_TAGS) else "K1/K2" if PROFILE_TAG["bcq"] in name
                else "copies" if any(t in low for t in ("copy", "memcpy", "memset")) else "other")
        parts[part] += ms
    return parts


def prefix_profiles(bcq_engine, max_seq):
    """What a cold wave costs against no cache: the cold wave (a fresh
    cache, ``prefill_chunk=PREFIX_CHUNK``), a cold wave with a fresh cache
    and whole-shot admissions, and the requests without a cache, each run
    once untraced and once traced (:func:`device_profile`), each run on an
    engine and cache of its own → {run: summary}."""
    import numpy as np

    from repro_torch.infer import PrefixCache
    from repro_torch.launch.serve import drive_continuous

    cfg, n = bcq_engine.cfg, len(PREFIX_TAILS)
    out = {}
    for name, cached, chunk in (("cold wave", True, PREFIX_CHUNK), ("cold wave, whole-shot", True, None),
                                ("no cache", False, None)):
        def wave():
            cache = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES) if cached else None
            engine = serving_engine(bcq_engine, max_seq, prefix_cache=cache)
            return drive_continuous(engine, prefix_requests(cfg), np.zeros(n), n_slots=SERVE_SLOTS,
                                    chunk=SERVE_CHUNK, prefill_chunk=chunk)

        sched, _, wall = wave()
        device_ms, traced_ms, by_name = device_profile(wave)
        parts = device_split(by_name)
        ttft = sched.summary()["ttft_s"]
        dispatches = sum(rec.prefill_chunks for rec in sched.outcomes.values())
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, ttft_s=ttft, prefill_dispatches=dispatches,
                         decode_steps=sched.decode_steps, device_ms=device_ms, traced_wall_ms=traced_ms,
                         busy_share=device_ms / (wall * 1e3), device_by_part=parts)
        log(f"  [prefix profile] {name}: {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s, TTFT p50 "
            f"{ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s, {dispatches} prefill dispatches, {sched.decode_steps} "
            f"decode steps; traced: device busy {device_ms:.2f} ms of {traced_ms:.2f} ms traced wall "
            f"({device_ms / traced_ms:.1%}; {device_ms / (wall * 1e3):.1%} of the untraced wall); device ms by "
            "part: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return out


def prefix_runs(bcq_engine, long_whole):
    """Phase 8's runs (module docstring) → summary."""
    import numpy as np

    from repro_torch.infer import PrefixCache
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import drive_continuous

    cfg = bcq_engine.cfg
    L, n = cfg.n_layers, len(PREFIX_TAILS)
    max_seq = PREFIX_LEN + max(PREFIX_TAILS) + NEW_TOKENS + 8
    cache = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES)
    warm = serving_engine(bcq_engine, max_seq, prefix_cache=cache)
    plain = serving_engine(bcq_engine, max_seq)
    runs, out = {}, {}
    # warm-up, as in phase 6: 6 of the requests, chunked, on a cache of their own (4 miss, 2 hit)
    drive_continuous(serving_engine(bcq_engine, max_seq, prefix_cache=PrefixCache(
        block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES)), prefix_requests(cfg)[:SERVE_SLOTS + 2],
        np.zeros(SERVE_SLOTS + 2), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, prefill_chunk=PREFIX_CHUNK)
    copies0 = flash_attention.copies
    for name, engine, chunk in (("cold wave", warm, PREFIX_CHUNK), ("warm wave", warm, PREFIX_CHUNK),
                                ("no cache", plain, None)):
        logits = record_admissions(engine)
        reqs = prefix_requests(cfg)
        hits0 = cache.counters["hits"]
        (sched, done, wall), _, counts, ref_calls = run_counted(lambda: drive_continuous(
            engine, reqs, np.zeros(n), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, prefill_chunk=chunk))
        offset = flash_attention.offset_launches
        del engine.finish_admission
        summ = sched.summary()
        if len(done) != n or summ["by_state"] != {"finished": n}:
            raise SystemExit(f"chip_smoke: [prefix {name}] not every request finished: {summ['by_state']}")
        rows, offsets = chunk_launches(sched, reqs, chunk)
        dispatches = len(rows)
        expect = expect_forward_counts(counts, sched.decode_steps, rows, L)
        hit = [sched.outcomes[r.rid].prefix_hit_tokens for r in reqs]
        by_rid = {c.rid: c.new_tokens for c in done}
        runs[name] = dict(tokens=[by_rid[r.rid] for r in reqs], logits=[logits[prompt_key(r.prompt)] for r in reqs])
        ttft = summ["ttft_s"]
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, ttft_s=ttft, tpot_s=summ["tpot_s"],
                         hit_tokens=hit, hits=cache.counters["hits"] - hits0 if engine is warm else 0,
                         prefill_dispatches=dispatches, launches=counts, offset_launches=offset,
                         cached_bytes=cache.cached_bytes if engine is warm else 0)
        log(f"  [prefix {name}] {n} requests ({PREFIX_LEN}-token shared prompt + {min(PREFIX_TAILS)}-"
            f"{max(PREFIX_TAILS)}-token tails, {NEW_TOKENS} new), {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}, "
            f"prefill_chunk {chunk}: {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s, TTFT p50 {ttft['p50']:.3f}s "
            f"p95 {ttft['p95']:.3f}s; hit tokens {sum(hit)} ({hit}); {dispatches} prefill dispatches; "
            f"K8 {counts['flash_attention']} launches, {offset} at q_start > 0")
        if counts != expect or offset != offsets * L:
            raise SystemExit(f"chip_smoke: [prefix {name}] launches {counts} (offset {offset}) != expected "
                             f"{expect} (offset {offsets * L})")
        if ref_calls:
            raise SystemExit(f"chip_smoke: [prefix {name}] took the ref oracle {ref_calls} times")
    c = cache.counters
    st = cache.stats()
    if flash_attention.copies != copies0:
        raise SystemExit("chip_smoke: [prefix] K8 copied a cache view instead of reading it in place")
    log(f"  [prefix] cache: {c['hits']} hits / {c['misses']} misses, {c['commits']} commits, {c['aborts']} "
        f"aborts, {c['evictions']} evictions, {st['cached_bytes'] / 1e6:.1f} MB cached in {st['nodes']} blocks "
        f"of {PREFIX_BLOCK} tokens (budget {PREFIX_CACHE_BYTES / 1e6:.1f} MB), pinned {st['pinned']}")
    if c["hits"] + c["misses"] != c["commits"] + c["aborts"] or st["pinned"]:
        raise SystemExit(f"chip_smoke: [prefix] the cache's accounting is not clean: {st}")
    if out["warm wave"]["hits"] != n or min(out["warm wave"]["hit_tokens"]) < PREFIX_LEN:
        raise SystemExit(f"chip_smoke: [prefix] the warm wave did not hit on every request: "
                         f"{out['warm wave']['hit_tokens']}")
    ref = runs["no cache"]
    for name in ("cold wave", "warm wave"):
        same_tok = [bool(np.array_equal(a, b)) for a, b in zip(runs[name]["tokens"], ref["tokens"])]
        same_log = [bool(torch.equal(a, b)) for a, b in zip(runs[name]["logits"], ref["logits"])]
        log(f"  [prefix] {name} vs whole-shot without a cache: tokens equal {sum(same_tok)}/{n}, last-prompt "
            f"logits bitwise equal {sum(same_log)}/{n}")
        out[name].update(tokens_equal=sum(same_tok), logits_equal=sum(same_log))
        if not (all(same_tok) and all(same_log)):
            raise SystemExit(f"chip_smoke: [prefix] the {name} differs from whole-shot admission: tokens "
                             f"{same_tok}, logits {same_log}")
    reqs = prefix_requests(cfg)
    greedy = [(i, r) for i, r in enumerate(reqs) if r.temperature == 0]
    for i, r in greedy:
        solo = plain.generate(r.prompt[None], r.max_new_tokens)
        if not np.array_equal(solo.tokens[0, r.prompt.size:], ref["tokens"][i]):
            raise SystemExit(f"chip_smoke: [prefix] greedy request {i} differs from its solo generate")
    log(f"  [prefix] greedy requests == solo generate: {len(greedy)}/{len(greedy)}")

    # each admission's prefill device time: cold (whole-shot, no cache) and warm (its blocks cached)
    cold_ms, warm_ms = [], []
    for r in reqs:
        for engine, dest in ((plain, cold_ms), (warm, warm_ms)):
            slots = engine.init_slots(1)
            ms, _, _ = device_profile(lambda: engine.admit_slot(slots, 0, r.prompt, max_new_tokens=NEW_TOKENS))
            dest.append(ms)
    log("  [prefix] admission device ms, cold -> warm: " + ", ".join(
        f"{r.prompt.size}: {a:.2f} -> {b:.2f}" for r, a, b in zip(reqs, cold_ms, warm_ms))
        + f"; total {sum(cold_ms):.2f} -> {sum(warm_ms):.2f} ms ({sum(warm_ms) / sum(cold_ms):.1%})")
    out.update(cold_admission_ms=cold_ms, warm_admission_ms=warm_ms, cache=st)
    if cache.pinned:
        raise SystemExit("chip_smoke: [prefix] pins left after the profiled admissions")
    del warm, plain
    out["profiles"] = prefix_profiles(bcq_engine, max_seq)
    out["long"] = long_chunked(bcq_engine, *long_whole)
    return out


def long_chunked(bcq_engine, whole, whole_logits, whole_tokens):
    """Phase 6's 8192-token request through a 1-slot scheduler with
    ``prefill_chunk=LONG_CHUNK``: 8 chunks, the last at q_start = 7168. Its
    tokens and last-prompt logits must equal the whole-shot run's, bitwise."""
    import numpy as np

    from repro_torch.infer import RequestState, Scheduler
    from repro_torch.kernels import flash_attention
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = bcq_engine.cfg
    L, S = cfg.n_layers, LONG_SEQ_THRESHOLD
    engine = serving_engine(bcq_engine, S + LONG_NEW)
    (req,) = serve_requests(cfg, (S,), LONG_NEW, 500)  # phase 6's request
    logits = record_admissions(engine)

    def run():
        sched = Scheduler(engine, n_slots=1, chunk=SERVE_CHUNK, prefill_chunk=LONG_CHUNK, clock=synced_clock)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rid = sched.submit(dataclasses.replace(req, rid=None))
        (c,) = sched.run()
        peak = torch.cuda.max_memory_allocated() - base
        rec = sched.outcomes[rid]
        stamps = dict(rec.history)
        return c.new_tokens, stamps[RequestState.DECODING] - stamps[RequestState.PREFILLING], peak, rec.prefill_chunks

    (toks, prefill_s, peak, chunks), wall, counts, ref_calls = run_counted(run)
    offset = flash_attention.offset_launches
    del engine.finish_admission
    n_chunks = -(-S // LONG_CHUNK)
    same_tok = bool(np.array_equal(toks, whole_tokens))
    same_log = bool(torch.equal(logits[prompt_key(req.prompt)], whole_logits))
    log(f"  [prefix long] {S}-token prompt in {chunks} chunks of {LONG_CHUNK} (the last at q_start = "
        f"{(n_chunks - 1) * LONG_CHUNK}) + {LONG_NEW} new tokens: prefill {prefill_s:.3f}s against whole-shot "
        f"{whole['prefill_s']:.3f}s; peak device memory {peak / 1e9:.3f} GB above the resident (whole-shot "
        f"{whole['peak_gb']:.3f} GB); K8 {counts['flash_attention']} launches, {offset} at q_start > 0; "
        f"tokens {'equal' if same_tok else 'DIFFER'}, last-prompt logits "
        f"{'bitwise equal' if same_log else 'DIFFER'} to the whole-shot run")
    if chunks != n_chunks or counts["flash_attention"] != n_chunks * L or offset != (n_chunks - 1) * L:
        raise SystemExit(f"chip_smoke: [prefix long] {chunks} chunks, K8 {counts['flash_attention']} launches "
                         f"({offset} offset); expected {n_chunks}, {n_chunks * L} ({(n_chunks - 1) * L})")
    if ref_calls:
        raise SystemExit(f"chip_smoke: [prefix long] took the ref oracle {ref_calls} times")
    if not (same_tok and same_log):
        raise SystemExit("chip_smoke: [prefix long] the chunked prefill differs from the whole-shot one")
    return dict(prompt_len=S, chunk=LONG_CHUNK, chunks=chunks, prefill_s=prefill_s, whole_prefill_s=whole["prefill_s"],
                peak_gb=peak / 1e9, whole_peak_gb=whole["peak_gb"], wall_s=wall, launches=counts,
                offset_launches=offset, tokens_equal=same_tok, logits_equal=same_log)


# -- phase 10: captured decode and the int8 cache -----------------------------


def decode_loop(engine, prompts, captured):
    """Prefill ``prompts`` → a function that runs ``NEW_TOKENS`` greedy
    decode steps from the prefill's logits, through the engine's decode graph
    (``generate(scan=True)``'s) or eagerly into a fresh cache at scalar
    positions (``scan=False``'s), and returns their ``(B, n, V)`` logits.
    Run it again and it rewrites the same rows with the same values."""
    tokens = torch.as_tensor(prompts, device=DEVICE).long()
    b, s = tokens.shape
    graph = engine._generate_graph(b) if captured else None
    logits0, cache = engine.prefill(tokens, graph.cache if captured else engine._make_cache(b))

    def loop():
        logits, c, out = logits0, cache, []
        for step in range(NEW_TOKENS):
            tok = torch.argmax(logits, dim=-1)
            if captured:
                logits = graph(tok, s + step).clone()
            else:
                logits, c = engine.decode(tok[:, None], c, s + step)
            out.append(logits)
        return torch.stack(out, dim=1)

    return loop


def graph_path(engine, prompts, label, mode=None):
    """One format path, captured against eager: every step's logits and the
    sampled ``generate``'s tokens bit for bit, the census equal, and each
    decode loop's wall, tok/s, device-busy share and launches a step."""
    from repro_torch.kernels import impl_mode

    from repro_torch.kernels import ternary_mm

    n_tok = PROMPTS * NEW_TOKENS
    out, traces = {}, {}
    with impl_mode(mode):
        for name, captured in (("eager", False), ("graph", True)):
            loop = decode_loop(engine, prompts, captured)
            if captured:  # the graph's warm-up and capture, where phase 5 did not make them
                first = loop()
            again, wall, counts, _ = run_counted(loop)
            if captured and not torch.equal(first, again):
                raise SystemExit(f"chip_smoke: [graphs] {label}: a rerun of the replayed loop changed its logits")
            traced_loop = decode_loop(engine, prompts, captured)  # its prefill: outside the window
            (device_ms, traced_ms, _, traces[name]), _, traced_counts, _ = run_counted(
                lambda: device_profile(traced_loop, events=True))
            if traced_counts != counts:
                raise SystemExit(f"chip_smoke: [graphs] {label} {name}: the traced loop's census {traced_counts} "
                                 f"!= the untraced loop's {counts}")
            _, missed = check_trace_census(f"graphs, {label} {name}", traces[name], traced_counts,
                                           ternary_mm.tc_launches)
            out[name] = dict(logits=again, wall_s=wall, tok_s=n_tok / wall, device_ms=device_ms, census_less_traced=missed,
                             busy_share=device_ms / (wall * 1e3), traced_wall_ms=traced_ms,
                             launches_per_step=sum(counts.values()) / NEW_TOKENS,
                             device_kernels_per_step=sum(traces[name].values()) / NEW_TOKENS)
        logits_equal = torch.equal(out["graph"].pop("logits"), out["eager"].pop("logits"))
        runs = {}
        for name, scan in (("eager", False), ("graph", True)):
            runs[name] = run_counted(lambda: engine.generate(prompts, NEW_TOKENS, temperature=0.8, seed=7, scan=scan))
    tokens_equal = bool((runs["graph"][0].tokens == runs["eager"][0].tokens).all())
    counts_equal = runs["graph"][2] == runs["eager"][2]
    graph = engine._graphs[(PROMPTS, mode)]
    e, g = out["eager"], out["graph"]
    log(f"  [graphs] {label}: {NEW_TOKENS} decode steps at B = {PROMPTS}, eager {e['wall_s'] * 1e3:.2f} ms "
        f"({e['tok_s']:.1f} tok/s, device {e['device_ms']:.2f} ms, busy {e['busy_share']:.1%}) | graph "
        f"{g['wall_s'] * 1e3:.2f} ms ({g['tok_s']:.1f} tok/s, device {g['device_ms']:.2f} ms, busy "
        f"{g['busy_share']:.1%}): {g['tok_s'] / e['tok_s']:.2f}x; a step: {g['launches_per_step']:.0f} kernel-wrapper "
        f"launches (eager {e['launches_per_step']:.0f}), device events traced {g['device_kernels_per_step']} "
        f"(eager {e['device_kernels_per_step']}); logits equal {logits_equal}, sampled generate tokens equal "
        f"{tokens_equal}, census equal {counts_equal}; the graph's kernel nodes "
        f"{({k: v for k, v in GRAPH_NODES[graph].items() if v})} (its capture's counts); the census less the "
        f"traced launches {e['census_less_traced'] or 0} (eager), {g['census_less_traced'] or 0} (graph); pool "
        f"{POOL_BYTES[graph] / 1e6:.1f} MB, workspace {graph.workspace.nbytes() / 1e6:.2f} MB, {graph.replays} replays")
    if not (logits_equal and tokens_equal and counts_equal):
        raise SystemExit(f"chip_smoke: [graphs] {label}: the replayed graph differs from the eager loop "
                         f"(logits {logits_equal}, tokens {tokens_equal}, census {counts_equal}: "
                         f"{runs['graph'][2]} vs {runs['eager'][2]})")
    return dict(eager=e, graph=g, speedup=g["tok_s"] / e["tok_s"], pool_bytes=POOL_BYTES[graph],
                workspace_bytes=graph.workspace.nbytes(), generate_wall_s={k: v[1] for k, v in runs.items()})


def graph_serving(bcq_engine):
    """Phase 6's 12 requests through 4 slots, the slot graph against the
    eager slot loop: the same tokens at temperatures 0, 1.0 and 0.7, the same
    census; wall, tok/s, TTFT and busy share of each."""
    import numpy as np

    from repro_torch.infer import engine as engine_mod
    from repro_torch.launch.serve import drive_continuous

    cfg = bcq_engine.cfg
    n = len(SERVE_PROMPT_LENS)
    engine = serving_engine(bcq_engine, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)

    def serve():
        reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200)
        sched, done, wall = drive_continuous(engine, reqs, np.zeros(n), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
        by_rid = {c.rid: c.new_tokens for c in done}
        return [by_rid[r.rid] for r in reqs], sched, wall

    out, tokens, traces = {}, {}, {}
    for name, eager in (("eager", True), ("graph", False)):
        engine_mod._EAGER_SLOT_STEPS = eager
        try:  # no warm-up: phase 6 ran these requests on the same weights
            (toks, sched, wall), _, counts, _ = run_counted(serve)
            (device_ms, traced_ms, _, traces[name]), _, traced_counts, _ = run_counted(
                lambda: device_profile(serve, events=True))
        finally:
            engine_mod._EAGER_SLOT_STEPS = False
        if traced_counts != counts:
            raise SystemExit(f"chip_smoke: [graphs] continuous {name}: the traced run's census {traced_counts} "
                             f"!= the untraced run's {counts}")
        _, missed = check_trace_census(f"graphs, continuous {name}", traces[name], counts)
        tokens[name] = toks
        ttft = sched.summary()["ttft_s"]
        pool = POOL_BYTES[sched.slots["graphs"][None]] if not eager else 0
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, ttft_s=ttft, device_ms=device_ms,
                         busy_share=device_ms / (wall * 1e3), traced_wall_ms=traced_ms, counts=counts,
                         decode_steps=sched.decode_steps, pool_bytes=pool, census_less_traced=missed,
                         launches_per_forward=sum(counts.values()) / (n + sched.decode_steps))
        log(f"  [graphs] continuous {name}: {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s, TTFT p50 "
            f"{ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s, {sched.decode_steps} decode steps; traced rerun: device "
            f"{device_ms:.2f} ms ({device_ms / (wall * 1e3):.1%} of the untraced wall); "
            f"{out[name]['launches_per_forward']:.0f} kernel-wrapper launches a forward, the census less the traced "
            f"launches {missed or 0}; pool {pool / 1e6:.1f} MB")
    same = [bool(np.array_equal(a, b)) for a, b in zip(tokens["graph"], tokens["eager"])]
    log(f"  [graphs] continuous: tokens equal, slot graph vs eager slot loop: {sum(same)}/{n} "
        f"(temperatures 0, 1.0, 0.7); census equal {out['graph']['counts'] == out['eager']['counts']}; "
        f"{out['graph']['tok_s'] / out['eager']['tok_s']:.2f}x tok/s")
    if not all(same) or out["graph"]["counts"] != out["eager"]["counts"]:
        raise SystemExit("chip_smoke: [graphs] the slot graph's tokens or census differ from the eager slot loop's")
    return dict(out, speedup=out["graph"]["tok_s"] / out["eager"]["tok_s"])


def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def int8_steps(bcq_engine):
    """The decode step's device time with the bf16 and the int8 cache at
    B = 64 and 4, ``max_seq`` 2048, as graph replays, median of 7; the
    caches' resident bytes and each capture's pool (the engine keeps one
    width's cache and graphs: the B = 4 ones replace the B = 64 ones)."""
    from repro_torch.infer import Engine
    from repro_torch.utils import tree_leaves

    out = {}
    for kv in ("bfloat16", "int8"):
        cfg = dataclasses.replace(bcq_engine.cfg, kv_cache_dtype=kv)
        engine = Engine(cfg, bcq_engine.params, max_seq=INT8_MAX_SEQ, fuse=False, device="cuda")
        for B in INT8_BATCHES:
            graph = engine._generate_graph(B)
            tok = torch.zeros((B,), dtype=torch.long, device=DEVICE)
            pos = torch.full((B,), INT8_MAX_SEQ // 2, dtype=torch.long, device=DEVICE)
            graph(tok, pos)  # warm-up
            graph(tok, pos)  # capture, then a replay
            ms = _median_event_ms(graph.graph.replay, 1, 7)
            cache_bytes = sum(leaf.nbytes for leaf in tree_leaves(graph.cache))
            out[(kv, B)] = dict(step_ms=ms, cache_bytes=cache_bytes, pool_bytes=POOL_BYTES[graph])
        log(f"  [int8] {kv} cache, max_seq {INT8_MAX_SEQ}: " + "; ".join(
            f"B = {B}: step {out[(kv, B)]['step_ms']:.3f} ms, cache {out[(kv, B)]['cache_bytes'] / 1e9:.3f} GB, "
            f"pool {out[(kv, B)]['pool_bytes'] / 1e9:.3f} GB" for B in INT8_BATCHES)
            + f"; then allocated: {torch.cuda.memory_allocated() / 1e9:.3f} GB (the weights, the last width's "
              f"cache and graph)")
        del engine, graph
        torch.cuda.empty_cache()
    for B in INT8_BATCHES:
        a, b = out[("int8", B)], out[("bfloat16", B)]
        log(f"  [int8] B = {B}: int8 step {a['step_ms'] / b['step_ms']:.2f}x the bf16 step, cache "
            f"{a['cache_bytes'] / b['cache_bytes']:.3f}x")
    return {f"{kv}/B={B}": v for (kv, B), v in out.items()}


def int8_exactness(bcq_engine, prompts):
    """The int8 cache at full width: decode logits within 5% (relative L2)
    of the bf16 cache's on the same tokens; slot == solo and greedy
    speculative == plain, bit for bit."""
    import numpy as np

    from repro_torch.infer import Engine, SpecConfig
    from repro_torch.launch.serve import drive_continuous

    cfg8 = dataclasses.replace(bcq_engine.cfg, kv_cache_dtype="int8")
    eng8 = Engine(cfg8, bcq_engine.params, max_seq=bcq_engine.max_seq, fuse=False, device="cuda")
    toks = torch.as_tensor(bcq_engine.generate(prompts, NEW_TOKENS).tokens, device=DEVICE).long()
    runs = {}
    for name, eng in (("bf16", bcq_engine), ("int8", eng8)):
        l0, cache = eng.prefill(toks[:, :PROMPT_LEN], eng._make_cache(PROMPTS))
        steps = []
        for t in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS - 1):
            lg, cache = eng.decode(toks[:, t : t + 1], cache, t)
            steps.append(lg)
        runs[name] = (l0, steps)
    worst = max(rel_l2(a, b) for a, b in zip(runs["int8"][1], runs["bf16"][1]))
    prefill_same = torch.equal(runs["int8"][0], runs["bf16"][0])
    log(f"  [int8] full-width decode logits against the bf16 cache (teacher-forced, {NEW_TOKENS - 1} steps): "
        f"worst relative L2 {worst:.4f} (bound {INT8_REL_L2}); prefill logits equal {prefill_same}")
    n_spec = NEW_TOKENS // 2  # random weights accept ~nothing: a chunk a token, the host's pace
    spec = eng8.generate(prompts, n_spec, speculate=SpecConfig(SPEC_Q, SPEC_GAMMA))
    plain = eng8.generate(prompts, n_spec)
    spec_same = bool((spec.tokens == plain.tokens).all())
    serving = serving_engine(eng8, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)
    reqs = serve_requests(cfg8, SERVE_PROMPT_LENS, NEW_TOKENS, 200)
    (sched, done, wall), _, counts, _ = run_counted(lambda: drive_continuous(
        serving, reqs, np.zeros(len(reqs)), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK))
    by_rid = {c.rid: c.new_tokens for c in done}
    same = [bool(np.array_equal(by_rid[r.rid], serving.generate(r.prompt[None], r.max_new_tokens,
                                                                temperature=r.temperature, seed=r.seed)
                                .tokens[0, r.prompt.size:])) for r in reqs]
    greedy = [r.temperature == 0 for r in reqs]
    log(f"  [int8] greedy speculative == plain ({SpecConfig(SPEC_Q, SPEC_GAMMA)}): {spec_same}; slot == solo "
        f"through {SERVE_SLOTS} slots: greedy {sum(a for a, g in zip(same, greedy) if g)}/{sum(greedy)}, sampled "
        f"{sum(a for a, g in zip(same, greedy) if not g)}/{len(reqs) - sum(greedy)}; continuous {wall:.3f}s, "
        f"{len(reqs) * NEW_TOKENS / wall:.1f} tok/s")
    if not (worst < INT8_REL_L2 and prefill_same and spec_same and all(same)):
        raise SystemExit(f"chip_smoke: [int8] logits {worst:.4f} (bound {INT8_REL_L2}), prefill equal "
                         f"{prefill_same}, spec == plain {spec_same}, slot == solo {sum(same)}/{len(reqs)}")
    return dict(decode_rel_l2=worst, spec_equal=spec_same, slot_equal=sum(same), requests=len(reqs),
                continuous_tok_s=len(reqs) * NEW_TOKENS / wall), eng8


def admission_logits(engine, prompt, chunk=None):
    """One admission (whole-shot, or in ``chunk``-token pieces) into a fresh
    1-slot batch → its last-prompt logits and the pending admission."""
    slots = engine.init_slots(1)
    p = engine.begin_admission(prompt, max_new_tokens=1, chunked=chunk is not None)
    while not p.done:
        engine.advance_admission(p, chunk)
    engine.finish_admission(slots, 0, p)
    return slots["logits"][0].clone(), p


def int8_admissions(eng8):
    """Under int8 a warm or chunked admission attends dequantized rows where
    the cold whole-shot one attends fresh rows: a warm prefix-cache admission
    (phase 8's 512-token shared prompt) and the 8192-token request in 8
    chunks, each within 5% (relative L2) of its cold whole-shot admission."""
    from repro_torch.infer import PrefixCache
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = eng8.cfg
    reqs = prefix_requests(cfg)[:2]
    cache = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES)
    warm_eng = serving_engine(eng8, max(r.prompt.size for r in reqs) + NEW_TOKENS + 8, prefix_cache=cache)
    cold, _ = admission_logits(warm_eng, reqs[0].prompt)  # a miss: commits the shared prompt's blocks
    cold2, _ = admission_logits(serving_engine(eng8, warm_eng.max_seq), reqs[1].prompt)
    warm, p = admission_logits(warm_eng, reqs[1].prompt)
    warm_rel = rel_l2(warm, cold2)
    (req,) = serve_requests(cfg, (LONG_SEQ_THRESHOLD,), LONG_NEW, 500)
    long_eng = serving_engine(eng8, LONG_SEQ_THRESHOLD + LONG_NEW)
    (whole, _), t_whole = timed(lambda: admission_logits(long_eng, req.prompt))
    (chunked, pc), t_chunked = timed(lambda: admission_logits(long_eng, req.prompt, LONG_CHUNK))
    long_rel = rel_l2(chunked, whole)
    log(f"  [int8] warm admission (hit {p.handle.length} of {reqs[1].prompt.size} tokens) against cold whole-shot: "
        f"relative L2 {warm_rel:.4f}; the {LONG_SEQ_THRESHOLD}-token prompt in {pc.prefill_chunks} chunks "
        f"({t_chunked:.3f}s) against whole-shot ({t_whole:.3f}s): {long_rel:.4f} (bound {INT8_REL_L2})")
    if not (p.handle.length >= PREFIX_LEN - PREFIX_BLOCK and warm_rel < INT8_REL_L2 and long_rel < INT8_REL_L2
            and pc.prefill_chunks == LONG_SEQ_THRESHOLD // LONG_CHUNK):
        raise SystemExit(f"chip_smoke: [int8] warm {warm_rel:.4f} (hit {p.handle.length}), chunked {long_rel:.4f} "
                         f"({pc.prefill_chunks} chunks)")
    return dict(warm_rel_l2=warm_rel, warm_hit=p.handle.length, long_rel_l2=long_rel, long_whole_s=t_whole,
                long_chunked_s=t_chunked)


def phase_graphs(engines, prompts):
    """Phase 10 (module docstring) → summary."""
    from repro_torch.kernels import flash_attention

    out = {"paths": {}}
    for fmt, engine in engines.items():
        out["paths"][fmt] = graph_path(engine, prompts, fmt)
    out["paths"]["bcq on lutgemm"] = graph_path(engines["bcq"], prompts, "bcq on lutgemm", "lutgemm")
    out["continuous"] = graph_serving(engines["bcq"])
    out["int8_steps"] = int8_steps(engines["bcq"])
    out["int8"], eng8 = int8_exactness(engines["bcq"], prompts)
    copies = flash_attention.copies
    out["int8"].update(int8_admissions(eng8))
    if flash_attention.copies != copies:
        raise SystemExit("chip_smoke: [int8] a dequantized K/V view did not reach K8 in place")
    return out


# -- phase 11: the serving session and observability --------------------------


def session_run(engine, reqs, *, observe, warm=False, cancel=None, profiler=None):
    """``reqs`` through a 4-slot ``ServeSession`` on ``engine``, in-process
    with asyncio and no sockets (the card's machine has no aiohttp); with
    ``observe`` the session's tracer is the engine's. ``warm``: a short
    request first, so the slot graph is captured before the window.
    ``cancel``: the index of a request cancelled at its first tokens.
    ``profiler``: started and stopped on the pump thread around the window →
    (session, [(tokens, terminal event)] in request order, the window's wall
    seconds, the tracer's events of the window)."""
    import asyncio

    from repro_torch.launch.server import ServeSession

    async def run():
        sess = ServeSession(engine, n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, observe=observe,
                            tracer=engine.tracer if observe else None)
        async with sess:
            if warm:
                (first,) = serve_requests(engine.cfg, (16,), 2, 900)
                await (await sess.submit_stream(first)).drain()
            if profiler is not None:
                await sess.call_on_pump(profiler.start)
            mark = len(sess.tracer.events()) if observe else 0
            await sess.call_on_pump(torch.cuda.synchronize)
            t0 = time.perf_counter()
            streams = [await sess.submit_stream(dataclasses.replace(r, rid=None)) for r in reqs]
            first, ended = [], None
            if cancel is not None:
                async for ev in streams[cancel]:
                    if ev.kind == "tokens":
                        first = ev.tokens
                        break
                    ended = ev if ev.terminal else None
                streams[cancel].cancel("cancelled mid-flight by chip_smoke")
            results = await asyncio.gather(*(st.drain() for st in streams))
            if cancel is not None:
                toks, last = results[cancel]
                results[cancel] = (first + toks, ended or last)
            wall = time.perf_counter() - t0
            if profiler is not None:
                await sess.call_on_pump(profiler.stop)
            events = sess.tracer.events()[mark:] if observe else []
        return sess, results, wall, events

    return asyncio.run(asyncio.wait_for(run(), 600))


def check_streams(label, reqs, results, solo, skip=()):
    """Every stream (but ``skip``) finished with its solo ``generate``'s
    tokens, bit for bit → how many."""
    bad = [i for i, (r, (toks, last)) in enumerate(zip(reqs, results))
           if i not in skip and (last.kind != "done" or toks != solo[i])]
    if bad:
        raise SystemExit(f"chip_smoke: [session {label}] requests {bad} differ from phase 6's solo generate "
                         f"(or did not finish): {[results[i][1].to_json() for i in bad]}")
    return len(reqs) - len(skip)


def check_slot_graph(label, sess):
    """The session's decode chunks replayed its slot graph, captured on the
    pump thread."""
    graph = sess.sched.slots["graphs"][None]
    where = CAPTURE_THREADS.get(graph)
    if graph.graph is None or graph.replays == 0 or where != "repro-serve-pump":
        raise SystemExit(f"chip_smoke: [session {label}] slot graph captured {graph.graph is not None} on "
                         f"{where!r}, {graph.replays} replays")
    return graph.replays


def scope_device_times(path):
    """Per ``record_function`` range of a ``torch.profiler`` Chrome trace
    whose name starts with ``engine/``: {name: (count, host ms, device ms)},
    and the device ms no range claims. A device event (kernel, copy, set)
    belongs to the innermost range, on the launching thread, around the
    runtime call with its correlation id (for a graph replay, its
    ``cudaGraphLaunch``)."""
    events = json.loads(Path(path).read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges, launch, device = collections.defaultdict(list), {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, corr = ev.get("cat", ""), (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and ev["name"].startswith("engine/"):
            ranges[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch[corr] = (ev["tid"], ev["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((corr, ev["dur"]))
    out = {}
    for spans in ranges.values():
        for t0, t1, name in spans:
            c, host, dev = out.get(name, (0, 0.0, 0.0))
            out[name] = (c + 1, host + (t1 - t0) / 1e3, dev)
    unclaimed = 0.0
    for corr, dur in device:
        tid, ts = launch.get(corr, (None, None))
        inside = [(t0, name) for t0, t1, name in ranges.get(tid, ()) if t0 <= ts <= t1] if tid is not None else []
        if not inside:
            unclaimed += dur / 1e3
            continue
        name = max(inside)[1]  # the innermost: the latest start
        c, host, dev = out[name]
        out[name] = (c, host, dev + dur / 1e3)
    return out, unclaimed


def phase_session(bcq_engine, solos):
    """Phase 11 (module docstring): phase 6's 12 requests through the async
    serving session, observed and not, cancelled mid-flight, profiled, and
    timed observed against unobserved → summary."""
    import numpy as np

    from repro_torch.kernels import launch_counts, qmatmul
    from repro_torch.obs import Tracer, parse_prometheus, validate_chrome_trace
    from repro_torch.obs.metrics import counters_agree
    from repro_torch.obs.trace import request_lifecycles

    cfg = bcq_engine.cfg
    L, n = cfg.n_layers, len(SERVE_PROMPT_LENS)
    # phase 6's cache length: a decode row's sums run over all max_seq rows,
    # so the solo tokens hold at this length (the cancelled request's 4x
    # budget fits in it: 200 + 64 rows)
    max_seq = max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8
    reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200)  # phase 6's
    solo = [o.tokens[0, r.prompt.size:].tolist() for r, o in zip(reqs, solos)]

    def engine(observe):
        """A fresh engine on the bcq weights (no copy): each session makes
        its slot state and captures its slot graph."""
        return serving_engine(bcq_engine, max_seq, tracer=Tracer() if observe else None)

    out = {}
    for name, observe in (("observed", True), ("unobserved", False)):
        eng = engine(observe)
        (sess, results, wall, events), _, counts, ref_calls = run_counted(
            lambda: session_run(eng, reqs, observe=observe))
        same = check_streams(name, reqs, results, solo)
        replays = check_slot_graph(name, sess)
        expect = expect_forward_counts(counts, sess.sched.decode_steps, [r.prompt.size for r in reqs], L)
        if counts != expect or ref_calls:
            raise SystemExit(f"chip_smoke: [session {name}] launches {counts} != expected {expect}, or the ref "
                             f"oracle took {ref_calls} dispatches")
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, equal_to_solo=same, replays=replays,
                         decode_steps=sess.sched.decode_steps, launches=counts,
                         ttft_s=sess.sched.summary()["ttft_s"])
        log(f"  [session {name}] {n} requests, {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}: streams == phase 6's solo "
            f"generate {same}/{n} (temperatures 0, 1.0, 0.7); slot graph captured on the pump thread, {replays} "
            f"replays; launches as expected {json.dumps(counts)}; {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s")
        if not observe:
            continue
        trace = sess.trace_json()
        problems = validate_chrome_trace(trace)
        lanes = request_lifecycles(trace)
        missing = [last.rid for _, last in results if f"req:{last.rid}" not in lanes]
        disagree = counters_agree(sess.registry, sess.sched.counters)
        samples = parse_prometheus(sess.prometheus())
        census = {ls["kernel"]: v for ls, v in samples["kernel_launches_total"]}
        ref_scraped = samples["qmatmul_ref_calls_total"][0][1]
        scopes = sorted({e[1] for e in events if e[3] == "engine"})
        log(f"  [session observed] trace: {trace['otherData']['buffered']} events, {len(problems)} problems, "
            f"{len(lanes)} request lanes ({len(missing)} missing); counters_agree: {disagree or 'empty'}; "
            f"Prometheus kernel_launches_total {json.dumps(census)} (census {json.dumps(launch_counts())}); "
            f"engine scopes {scopes}")
        if problems or missing or disagree or census != launch_counts() or ref_scraped != qmatmul.ref_calls:
            raise SystemExit(f"chip_smoke: [session observed] trace problems {problems[:3]}, lanes missing "
                             f"{missing}, counters {disagree}, scrape {census} vs census {launch_counts()}")
        out[name].update(trace_events=trace["otherData"]["buffered"], scopes=scopes,
                         scraped_launches=census)

    # one request cancelled at its first streamed tokens (its budget 4x, so
    # the cancel lands mid-flight); the survivors are exact
    creqs = list(reqs)
    creqs[SESSION_CANCEL] = dataclasses.replace(reqs[SESSION_CANCEL], max_new_tokens=4 * NEW_TOKENS)
    if creqs[SESSION_CANCEL].prompt.size + 4 * NEW_TOKENS > max_seq:
        raise SystemExit(f"chip_smoke: [session cancel] request {SESSION_CANCEL}'s 4x budget does not fit max_seq")
    sess, results, wall, _ = session_run(engine(True), creqs, observe=True, cancel=SESSION_CANCEL)
    toks, last = results[SESSION_CANCEL]
    same = check_streams("cancel", reqs, results, solo, skip=(SESSION_CANCEL,))
    log(f"  [session cancel] request {SESSION_CANCEL} cancelled after {len(toks)} streamed tokens "
        f"({last.kind}, {last.status}); survivors == solo generate {same}/{n - 1}")
    if last.status != "cancelled" or sess.sched.counters["cancelled"] != 1:
        raise SystemExit(f"chip_smoke: [session cancel] the cancelled request ended {last.to_json()}")
    out["cancel"] = dict(streamed_before_cancel=len(toks), survivors_equal=same)

    # the profile: a warmed session (its slot graph captured before the
    # profiler starts), the profiler started and stopped on the pump thread
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass  # the profiler initialises on this thread, before it starts on the pump
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    preqs = [dataclasses.replace(r, max_new_tokens=PROFILED_NEW) for r in reqs[:SESSION_PROFILED]]
    sess, results, wall, events = session_run(engine(True), preqs, observe=True, warm=True, profiler=prof)
    check_streams("profiled", preqs, results, [t[:PROFILED_NEW] for t in solo])
    path = ROOT / "chiprun_out" / "serve_profile.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    by_scope, unclaimed = scope_device_times(path)
    entered = {e[1] for e in events if e[3] == "engine"}
    log(f"  [session profile] {len(preqs)} requests ({[r.prompt.size for r in preqs]} prompt tokens, "
        f"{PROFILED_NEW} new each) after a warm-up, {wall:.3f}s; {path.name} "
        f"{path.stat().st_size / 1e6:.1f} MB; per engine scope (count, host ms, device ms):")
    for name, (c, host, dev) in sorted(by_scope.items()):
        log(f"    {name:24s} {c:5d} {host:10.2f} {dev:10.2f}")
    log(f"    device ms claimed by no engine scope: {unclaimed:.2f}")
    if not entered or entered - set(by_scope):
        raise SystemExit(f"chip_smoke: [session profile] scopes entered {sorted(entered)}, in the profile "
                         f"{sorted(by_scope)}")
    out["profile"] = dict(wall_s=wall, requests=len(preqs), file_mb=path.stat().st_size / 1e6,
                          scopes={k: dict(count=c, host_ms=h, device_ms=d) for k, (c, h, d) in by_scope.items()},
                          unclaimed_device_ms=unclaimed)

    # overhead: observed against unobserved, warmed, alternating; printed, not bounded
    tok_s = {True: [], False: []}
    for _ in range(SESSION_OVERHEAD_RUNS):
        for observe in (True, False):
            _, results, wall, _ = session_run(engine(observe), reqs, observe=observe, warm=True)
            check_streams("overhead", reqs, results, solo)
            tok_s[observe].append(n * NEW_TOKENS / wall)
    med = {k: statistics.median(v) for k, v in tok_s.items()}
    log(f"  [session overhead] tok/s observed {[round(v, 1) for v in tok_s[True]]} (median {med[True]:.1f}) "
        f"against unobserved {[round(v, 1) for v in tok_s[False]]} (median {med[False]:.1f}): "
        f"{med[True] / med[False]:.3f}x")
    out["overhead"] = dict(observed_tok_s=tok_s[True], unobserved_tok_s=tok_s[False],
                           ratio=med[True] / med[False])
    return out


def kernels_line(records, counts, n_layers, flash_records, spec_launches, flash_offsets, offset_launches):
    """Per kernel: its launches in its path's counted run and, in bf16 at the
    batched decode width, its time summed over one decode step's launches;
    for K8, in bf16, its time summed over the L launches of one
    8192-token prefill (one launch a layer at B = 1, S = 8192). Kernels on
    the speculative path also carry ``spec_launches``, their launches summed
    over phase 7's counted runs. K8 also carries its offset entry: its
    launches at ``q_start > 0`` over phase 8's counted runs
    (``offset_launches``) and, per checked (q_start, Sq) and dtype, one
    launch's numbers (``offset``)."""
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
        spec_launches=spec_launches[name], offset_launches=offset_launches,
        offset=[{key: o[key] for key in ("q_start", "Sq", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")} for o in flash_offsets],
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
    log("[1/11] card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), device {torch.cuda.get_device_name(0)}")

    phase_wall(walls)
    log("[2/11] build")
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
    log("[3/11] kernels against their plain versions")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    records = phase_kernels(gen)
    draft_records, draft_steps = draft_shapes(gen, records)
    limit_records = table_limit(gen)
    dense_rows = dense_rows_check(gen)
    prompt_tiles = prompt_tiles_check(gen)

    phase_wall(walls)
    log("[4/11] flash_attention against its plain version")
    flash_records, flash_offsets = phase_flash(gen)

    phase_wall(walls)
    log("[5/11] main path, one run per format")
    inspect_captures()
    counts, cfg, summaries, engines, prompts = phase_main_path()
    bcq_engine, ternary_engine = engines["bcq"], engines["ternary"]

    phase_wall(walls)
    log("[6/11] continuous serving and one long request")
    counts["flash_attention"], summaries["continuous"], serving = phase_serving(bcq_engine)
    summaries["long"], long_logits, long_tokens = phase_long(bcq_engine)

    phase_wall(walls)
    log("[7/11] self-speculative decoding")
    summaries["speculative"], spec_launches = phase_speculative(bcq_engine, ternary_engine, prompts, serving,
                                                                summaries["continuous"],
                                                                checked_shapes(records + draft_records))
    solos = serving["solos"]  # phase 11 holds its streams to them
    del ternary_engine, serving

    phase_wall(walls)
    log("[8/11] prefix cache and chunked prefill")
    summaries["prefix"] = phase_prefix(bcq_engine, (summaries["long"], long_logits, long_tokens),
                                       records + draft_records, gen)
    offset_launches = (sum(summaries["prefix"][run]["offset_launches"] for run in ("cold wave", "warm wave"))
                       + summaries["prefix"]["long"]["offset_launches"])
    del bcq_engine

    phase_wall(walls)
    log("[9/11] kernels (the JSON line is printed last but one)")
    line = kernels_line(records, counts, cfg.n_layers, flash_records, spec_launches, flash_offsets,
                        offset_launches)

    phase_wall(walls)
    log("[10/11] captured decode and the int8 cache")
    summaries["graphs"] = phase_graphs(engines, prompts)

    phase_wall(walls)
    log("[11/11] serving session and observability")
    summaries["session"] = phase_session(engines["bcq"], solos)
    del engines
    phase_wall(walls)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "layers": cfg.n_layers, "records": records, "flash_records": flash_records,
         "steps": {path: {B: path_step(records, names, B, cfg.n_layers) for B in (1, PROMPTS, PROMPTS * PROMPT_LEN)}
                   for path, names in STEP_PATHS.items()},
         "table_limit": limit_records, "dense_rows": dense_rows, "prompt_tiles": prompt_tiles,
         "flash_offsets": flash_offsets,
         "draft_records": draft_records, "draft_steps": draft_steps,
         "paths": summaries, **line},
        indent=1))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
