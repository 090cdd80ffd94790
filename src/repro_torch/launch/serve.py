"""Serving launcher: quantize, then serve requests through the
continuous-batching scheduler (counterpart of ``repro/launch/serve.py``;
the paper's §V workload: many concurrent decode requests against one
weight-resident quantized model).

PYTHONPATH=src python -m repro_torch.launch.serve                 # on the GPU
PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
PYTHONPATH=src python -m repro_torch.launch.serve --sequential --rate 8

The model is the reference launcher's reduced config of ``--arch`` (d_model
256, 4 kv heads, d_ff 512, 2 layers, vocab 256, f32), with random weights
from seed 0, quantized with ``--q``/``--g`` in ``--format`` (``--q 0``
serves it dense). ``--format`` takes every registered format: ``bcq``,
``uniform``, ``dequant``, ``ternary`` (always 2 planes, whatever ``--q``
says) and ``codebook``; on the GPU each serves through its own kernel, and
every prefill's attention through the flash-attention kernel. Requests come
from the same Markov corpus and seeds as the reference's, with
temperatures cycling 0, 1.0, 0.7.

By default requests enter an admission queue and are continuously batched
into a ``--slots``-wide decode batch (``repro_torch.infer.Scheduler``),
decoded ``--chunk`` steps per dispatch; each request's tokens equal a solo
``Engine.generate`` of it. ``--rate`` simulates Poisson arrivals
(requests/s; 0 = all queued at t=0). ``--sequential`` instead serves the
same workload as one ``generate`` call per request in arrival order, the
baseline the scheduler is measured against.

``--speculate QD:GAMMA`` serves the continuous path self-speculatively
(``infer/speculative.py``): the first QD planes of the ``bcq`` or
``ternary`` weights draft GAMMA tokens a chunk and the full model verifies
them; it prints the draft acceptance. It needs ``--q > 0`` and a
truncation-capable format, and cannot be combined with ``--sequential``.

``--prefix-cache-mb MB`` attaches a prefix cache of that budget
(``infer/prefix_cache.py``, blocks of ``--prefix-block`` tokens, default
16): an admission installs the longest cached prefix of its prompt and
prefills only the rest; the stats line reports hits, misses, commits,
evictions and the bytes cached. ``--shared-prefix-len N`` gives every
request the same first N prompt tokens (a shared system prompt, the
workload the cache is for). ``--prefill-chunk N`` prefills at most N prompt
tokens a scheduler step, between decode chunks. Tokens equal those of
cold whole-shot admission. The cache and chunking drive the scheduler and
cannot be combined with ``--sequential``.

``--trace-out PATH`` instruments the run with ``repro_torch.obs``: a span
tracer on the engine and the scheduler and a metrics registry; it writes
the Chrome / Perfetto trace-event JSON to PATH and prints the counters.
Spans time the host. ``--profile-dir DIR`` wraps the serve loop in
``torch.profiler.profile`` (CPU and, on the GPU, CUDA activity) and writes
its Chrome trace into DIR, where the engine's ``record_function`` ranges
(``engine/prefill``, ``engine/scan_decode``, ...) label the device's
kernels. :func:`pareto_arrivals` gives heavy-tailed arrivals at the mean
rate of :func:`poisson_arrivals`, for benchmarks.

``--arch recurrentgemma-9b`` serves the hybrid family (RG-LRU blocks and
local attention on a ring cache; reduced: 5 layers, window 16) through
every path above but chunked prefill, which the reference refuses for ring
and recurrent models too: ``--prefill-chunk`` is then an argparse error
naming its reason; a prompt past the window bypasses the prefix cache.
``--arch xlstm-125m`` serves the ssm family (mLSTM and sLSTM cells;
reduced: 2 layers) the same way, with the same refusal of
``--prefill-chunk``. ``--arch olmoe-1b-7b`` (or
``llama4-maverick-400b-a17b``) serves the MoE family (reduced: 2 layers,
at most 8 experts, top-2, ``moe_d_ff`` 256) with ``--sequential`` only:
expert capacity couples a batch's rows, so the continuous default raises
the reference's slot refusal, and speculation, the prefix cache and
chunked prefill are refused with it. ``--arch llama-3.2-vision-90b``
serves the vlm family (reduced: one period of 5 layers, 4 ``attn`` and a
``cross`` block over 8 image tokens) with ``--sequential`` only, as the
reference serves it: no image memory is given, so the cross blocks attend
zeros; the continuous default raises the reference's slot refusal.
``--arch musicgen-medium`` (frame-embedding inputs) is an argparse error,
as in the reference: serve it through ``Engine(embed_fn=...).generate``.

``--tp N`` serves tensor-parallel (``parallel/tp.py``): the weights are
quantized once here, then N ranks start (``launch/_ranks.py``: rank r on
``cuda:(r % device_count)``, NCCL when every rank has a card of its own,
else gloo; ``--device cpu``: gloo on the host), each splits them
column- and row-parallel, keeps its slices and its kv heads, and runs the
same serve loop (the loop's clock is rank 0's); rank 0 prints the report.
Greedy tokens equal ``--tp 1``'s. A split the model cannot take (heads or
``k/g`` groups not divisible by N, e.g. ``--tp 4 --g 128`` here: ``wo`` has
k = 256) is refused before the ranks start, naming the leaf; the
MoE, hybrid and ssm families are refused as the reference refuses them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.formats import format_names, get_format
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, PrefixCache, Request, Scheduler, SpecConfig
from repro_torch.infer.engine import CHUNK_REFUSAL
from repro_torch.infer.speculative import has_recurrent_state, has_ring_buffer
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch._ranks import run_ranks
from repro_torch.models import fuse_decode_projections, init_params, reduced
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.parallel.ctx import agree, collective_counts
from repro_torch.parallel.tp import check_tp, make_tp_mesh
from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes
from repro_torch.utils import tree_map


def build_requests(cfg, n, prompt_len, gen, *, mixed_temperature=True, seed=3, shared_prefix_len=0):
    """``n`` requests with prompts from the Markov corpus; temperatures cycle
    0, 1.0, 0.7 unless ``mixed_temperature`` is False (all greedy).
    ``shared_prefix_len > 0`` gives every request the same first tokens (a
    shared system prompt) followed by its own tail; the prompt length stays
    ``prompt_len``."""
    corpus = MarkovCorpus(cfg.vocab, seed=seed)
    if shared_prefix_len >= prompt_len:
        raise ValueError(
            f"shared_prefix_len ({shared_prefix_len}) must leave at least one per-request token "
            f"(prompt_len={prompt_len})"
        )
    shared = corpus.sample(1, prompt_len, seed=99)[0, :shared_prefix_len]
    reqs = []
    for i in range(n):
        prompt = corpus.sample(1, prompt_len, seed=100 + i)[0, :prompt_len]
        if shared_prefix_len:
            prompt = np.concatenate([shared, prompt[shared_prefix_len:]])
        temp = [0.0, 1.0, 0.7][i % 3] if mixed_temperature else 0.0
        reqs.append(Request(prompt=prompt.astype(np.int32), max_new_tokens=gen,
                            temperature=temp, seed=10 + i))
    return reqs


def poisson_arrivals(n, rate, seed=0):
    """Cumulative arrival offsets (seconds). rate<=0 → everything at t=0."""
    if rate <= 0:
        return np.zeros(n)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def pareto_arrivals(n, rate, alpha=1.5, seed=0):
    """Heavy-tailed (Lomax / Pareto-II) interarrivals with the mean rate of
    :func:`poisson_arrivals` but bursty clumps and long gaps: the tail
    regime where TTFT percentiles, queue bounds and deadline shedding
    matter. ``alpha`` is the tail index (smaller: heavier), > 1 for a finite
    mean; the Lomax mean is scale / (alpha - 1), so scale = (alpha - 1) /
    rate. The reference's draws at the same seed, bit for bit."""
    if rate <= 0:
        return np.zeros(n)
    if alpha <= 1:
        raise ValueError(f"alpha must be > 1 for a finite mean, got {alpha}")
    rng = np.random.default_rng(seed)
    scale = (alpha - 1.0) / rate
    return np.cumsum(rng.pareto(alpha, size=n) * scale)


def drive_continuous(engine, reqs, arrivals, *, n_slots, chunk, speculate=None, prefill_chunk=None,
                     tracer=None, metrics=None):
    """Wall-clock serve loop: submit each request at its arrival offset,
    step the scheduler whenever there is work. Returns (scheduler,
    completions, makespan seconds); the scheduler carries the utilisation
    counters and the lifecycle summary. ``speculate`` (a SpecConfig)
    serves speculatively, ``prefill_chunk`` prefills in chunks of that many
    tokens; ``tracer`` / ``metrics`` (``repro_torch.obs``) instrument the
    scheduler."""
    sched = Scheduler(engine, n_slots=n_slots, chunk=chunk, speculate=speculate, prefill_chunk=prefill_chunk,
                      tracer=tracer, metrics=metrics)
    done = []
    t0 = time.perf_counter()
    i = 0
    while len(done) < len(reqs):
        now = time.perf_counter() - t0
        if engine.mesh is not None:  # every rank admits on rank 0's clock
            now = agree(engine.mesh, now)
        while i < len(reqs) and arrivals[i] <= now:
            sched.submit(reqs[i])
            i += 1
        if sched.idle:
            # nothing in flight: sleep until the next arrival
            time.sleep(max(0.0, arrivals[i] - now))
            continue
        done.extend(sched.step())
    return sched, done, time.perf_counter() - t0


def drive_sequential(engine, reqs, arrivals):
    """One ``generate`` call per request, in arrival order."""
    t0 = time.perf_counter()
    outs = []
    for req, at in zip(reqs, arrivals):
        wait = at - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        outs.append(engine.generate(req.prompt[None], req.max_new_tokens,
                                    temperature=req.temperature, seed=req.seed))
    return outs, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--q", type=int, default=4,
                    help="quantization bits / code planes (0 = dense)")
    ap.add_argument("--g", type=int, default=128)
    ap.add_argument("--format", choices=format_names(), default="bcq",
                    help="registered quantization format (core/formats.py)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-batch width (concurrent requests)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per scheduler dispatch (admission "
                         "happens at chunk boundaries)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s (0 = all at t=0)")
    ap.add_argument("--sequential", action="store_true",
                    help="serve with one generate call per request instead "
                         "of the continuous-batching scheduler (baseline)")
    ap.add_argument("--speculate", type=str, default=None, metavar="QD:GAMMA")
    ap.add_argument("--prefix-cache-mb", type=int, default=0,
                    help="prefix-cache budget in MiB (0 = no cache): committed prompt prefixes "
                         "are reused across requests")
    ap.add_argument("--prefix-block", type=int, default=None,
                    help="prefix-cache block in tokens (default 16): prefixes match and commit "
                         "in whole blocks")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens prefilled a scheduler step, interleaved with decode "
                         "(0 = whole-shot)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="every request's prompt starts with the same tokens (a shared system "
                         "prompt), the prefix-cache workload")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: N ranks, each holding its slices of the weights "
                         "and its kv heads (greedy tokens identical to --tp 1)")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="instrument the run with the span tracer and metrics registry "
                         "(repro_torch.obs), write a Chrome/Perfetto trace here and print the "
                         "counters; host-side spans only (--profile-dir: device time)")
    ap.add_argument("--profile-dir", type=str, default=None, metavar="DIR",
                    help="wrap the serve loop in torch.profiler (CPU and CUDA activity) and write "
                         "its Chrome trace into DIR; off by default, profiling is never free")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)

    if args.tp < 1:
        ap.error("--tp must be >= 1")
    # refuse unwritable outputs now, not after the serve run
    if args.trace_out and not os.path.isdir(os.path.dirname(os.path.abspath(args.trace_out))):
        ap.error(f"--trace-out: the span tracer's trace would go to {args.trace_out!r}, whose "
                 f"directory does not exist")
    if args.profile_dir and os.path.exists(args.profile_dir) and not os.path.isdir(args.profile_dir):
        ap.error(f"--profile-dir: the profiler's trace directory {args.profile_dir!r} is a file")
    if args.slots < 1 or args.chunk < 1:
        ap.error("--slots and --chunk must be >= 1")
    spec = None
    if args.speculate:
        try:
            spec = SpecConfig.parse(args.speculate)
        except ValueError as e:
            ap.error(f"--speculate: {e}")
    if spec and not args.q:
        ap.error("--speculate requires a quantized model (--q > 0)")
    if spec and not get_format(args.format).supports_truncate:
        capable = [n for n in format_names() if get_format(n).supports_truncate]
        ap.error(f"--speculate needs a truncation-capable format; "
                 f"{args.format!r} has no nested low-bit draft "
                 f"(truncation-capable formats: {', '.join(capable)})")
    if spec and args.sequential:
        ap.error("--speculate drives the continuous-batching scheduler; "
                 "it cannot be combined with --sequential")
    if args.sequential and (args.prefix_cache_mb or args.prefill_chunk):
        ap.error("--prefix-cache-mb (the prefix cache) and --prefill-chunk (chunked prefill) drive "
                 "the scheduler; they cannot be combined with --sequential")
    if args.prefix_cache_mb < 0:
        ap.error("--prefix-cache-mb must be >= 0 (0 = no prefix cache)")
    if args.prefill_chunk < 0:
        ap.error("--prefill-chunk must be >= 0 (0 = whole-shot, no chunked prefill)")
    arch_cfg = get_config(args.arch)
    if arch_cfg.input_kind != "tokens":
        ap.error(f"{args.arch} is a modality-stub arch (frame-embedding inputs); serve it through "
                 f"Engine(embed_fn=...).generate")
    if args.prefill_chunk and (has_ring_buffer(arch_cfg) or has_recurrent_state(arch_cfg)):
        ap.error(f"--prefill-chunk: chunked prefill of {args.arch} is {CHUNK_REFUSAL}")
    if args.prefix_block is not None and not args.prefix_cache_mb:
        ap.error("--prefix-block sets the prefix cache's block; it needs --prefix-cache-mb")
    if args.prefix_block is not None and args.prefix_block < 1:
        ap.error("--prefix-block must be >= 1")
    if not 0 <= args.shared_prefix_len < args.prompt_len:
        ap.error(f"--shared-prefix-len (the prefix cache's shared prompt) must lie in [0, "
                 f"--prompt-len={args.prompt_len}): every request keeps at least one token of its own")

    # the reference launcher's reduced config (>=128-dim linears, so quantization bites)
    cfg = reduced(arch_cfg, d_model=256, n_kv_heads=4, d_ff=512 if arch_cfg.d_ff else 0,
                  moe_d_ff=256 if arch_cfg.n_experts else None)
    params = init_params(cfg, seed=0, device=args.device)
    print(f"dense bytes: {quantized_bytes(params)/2**20:.2f} MiB")
    if args.q:
        params = quantize_params(
            params, QuantPolicy(q=args.q, g=args.g, iters=4, fmt=args.format),
            device=args.device,
        )
        print(f"{args.format} q={args.q} g={args.g}: "
              f"{quantized_bytes(params)/2**20:.2f} MiB")
    if args.tp == 1:
        serve(args, cfg, params, spec)
        return
    # refuse a split the model cannot take before any rank starts (the
    # reference's words: the leaf and its dims, or the heads / block types)
    check_tp(cfg, fuse_decode_projections(cfg, params), args.tp)
    params = tree_map(lambda leaf: leaf.to("cpu"), params)  # quantized once, handed to every rank
    run_ranks(serve_rank, args.tp, (args, cfg, params, spec), device=args.device)


def serve_rank(rank, n, args, cfg, params, spec):
    """One rank of ``--tp n``: this rank's slice of ``params`` on its device."""
    serve(args, cfg, params, spec, mesh=make_tp_mesh(n))


def serve(args, cfg, params, spec, mesh=None) -> None:
    """Serve the CLI's workload on one device, or as one rank of ``mesh``
    (rank 0 reports and writes the trace and the profile)."""
    report = mesh is None or mesh.rank == 0
    say = print if report else (lambda *a, **k: None)
    headroom = spec.gamma + 1 if spec else 0
    prefix_cache = None
    if args.prefix_cache_mb:
        prefix_cache = PrefixCache(block_tokens=args.prefix_block or 16, max_bytes=args.prefix_cache_mb << 20)
    tracer = registry = None
    if args.trace_out and report:
        tracer, registry = Tracer(), MetricsRegistry()
    engine = Engine(cfg, params, max_seq=args.prompt_len + args.gen + 8 + headroom,
                    device=args.device, prefix_cache=prefix_cache, tracer=tracer, mesh=mesh)
    del params  # the engine holds the fused layout
    reqs = build_requests(cfg, args.requests, args.prompt_len, args.gen,
                          shared_prefix_len=args.shared_prefix_len)
    arrivals = poisson_arrivals(args.requests, args.rate, seed=1)
    total_new = sum(r.max_new_tokens for r in reqs)

    profiler = contextlib.nullcontext()
    if args.profile_dir and report:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)

    reset_launch_counts()
    if args.sequential:
        with profiler:
            outs, dt = drive_sequential(engine, reqs, arrivals)
        say(f"[sequential] {len(outs)} requests, {total_new} tokens in "
              f"{dt:.2f}s ({total_new/dt:.1f} tok/s on {engine.device})")
        sample = outs[0].tokens[0, args.prompt_len:]
    else:
        with profiler:
            sched, done, dt = drive_continuous(engine, reqs, arrivals, n_slots=args.slots,
                                               chunk=args.chunk, speculate=spec,
                                               prefill_chunk=args.prefill_chunk or None,
                                               tracer=tracer, metrics=registry)
        util = sched.steps_active / max(1, sched.decode_steps * sched.n_slots)
        tag, extra = "continuous", ""
        if spec:
            # steps_active counts committed tokens here; occupancy is the
            # dispatched row-chunks over capacity
            util = sched.chunk_rows / max(1, sched.decode_steps * sched.n_slots)
            tag = f"speculative q'={spec.q_draft} γ={spec.gamma}"
            extra = f", draft acceptance ~{sched.spec_accept_rate:.0%}"
        say(f"[{tag}] {len(done)} requests, {total_new} tokens in "
              f"{dt:.2f}s ({total_new/dt:.1f} tok/s on {engine.device}, "
              f"{args.slots} slots, chunk={args.chunk}, slot utilisation {util:.0%}{extra})")
        if prefix_cache is not None:
            st = prefix_cache.stats()
            say(f"prefix cache: {st['hits']} hits / {st['misses']} misses, {st['commits']} commits, "
                  f"{st['evictions']} evictions, {st['cached_bytes'] / 2**20:.2f} MiB cached "
                  f"({st['nodes']} blocks)")
        sample = done[0].new_tokens
    say("kernel launches:", launch_counts())
    if mesh is not None:
        say(f"collectives (rank 0): {collective_counts()}")
    say("sample:", sample)
    if args.profile_dir and report:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "serve_profile.json")
        profiler.export_chrome_trace(path)
        say(f"profile: {path} (torch.profiler Chrome trace; open in ui.perfetto.dev)")
    if tracer is not None:
        with open(args.trace_out, "w") as f:
            json.dump(tracer.to_chrome(), f)
        st = tracer.stats()
        say(f"trace: {args.trace_out} ({st['buffered']} events, {st['evicted']} evicted) — "
              f"open in ui.perfetto.dev")
        if not args.sequential:
            counters = {name: sum(s["value"] for s in fam["series"])
                        for name, fam in registry.snapshot().items() if fam["type"] == "counter"}
            say("metrics:", json.dumps(counters, sort_keys=True))


if __name__ == "__main__":
    main()
