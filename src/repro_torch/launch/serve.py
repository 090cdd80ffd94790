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

``--tp`` belongs to tensor parallelism, which is not ported yet; it is
refused with an error naming the missing piece.
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
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import init_params, reduced
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes


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
    ap.add_argument("--tp", type=int, default=1)
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

    if args.tp != 1:
        ap.error("--tp needs tensor parallelism (parallel/tp.py), not ported yet")
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
    if args.prefix_block is not None and not args.prefix_cache_mb:
        ap.error("--prefix-block sets the prefix cache's block; it needs --prefix-cache-mb")
    if args.prefix_block is not None and args.prefix_block < 1:
        ap.error("--prefix-block must be >= 1")
    if not 0 <= args.shared_prefix_len < args.prompt_len:
        ap.error(f"--shared-prefix-len (the prefix cache's shared prompt) must lie in [0, "
                 f"--prompt-len={args.prompt_len}): every request keeps at least one token of its own")

    # the reference launcher's reduced config (>=128-dim linears, so quantization bites)
    cfg = reduced(get_config(args.arch), d_model=256, n_kv_heads=4,
                  d_ff=512 if get_config(args.arch).d_ff else 0)
    params = init_params(cfg, seed=0, device=args.device)
    print(f"dense bytes: {quantized_bytes(params)/2**20:.2f} MiB")
    if args.q:
        params = quantize_params(
            params, QuantPolicy(q=args.q, g=args.g, iters=4, fmt=args.format),
            device=args.device,
        )
        print(f"{args.format} q={args.q} g={args.g}: "
              f"{quantized_bytes(params)/2**20:.2f} MiB")
    headroom = spec.gamma + 1 if spec else 0
    prefix_cache = None
    if args.prefix_cache_mb:
        prefix_cache = PrefixCache(block_tokens=args.prefix_block or 16, max_bytes=args.prefix_cache_mb << 20)
    tracer = registry = None
    if args.trace_out:
        tracer, registry = Tracer(), MetricsRegistry()
    engine = Engine(cfg, params, max_seq=args.prompt_len + args.gen + 8 + headroom,
                    device=args.device, prefix_cache=prefix_cache, tracer=tracer)
    del params  # the engine holds the fused layout
    reqs = build_requests(cfg, args.requests, args.prompt_len, args.gen,
                          shared_prefix_len=args.shared_prefix_len)
    arrivals = poisson_arrivals(args.requests, args.rate, seed=1)
    total_new = sum(r.max_new_tokens for r in reqs)

    profiler = contextlib.nullcontext()
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)

    reset_launch_counts()
    if args.sequential:
        with profiler:
            outs, dt = drive_sequential(engine, reqs, arrivals)
        print(f"[sequential] {len(outs)} requests, {total_new} tokens in "
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
        print(f"[{tag}] {len(done)} requests, {total_new} tokens in "
              f"{dt:.2f}s ({total_new/dt:.1f} tok/s on {engine.device}, "
              f"{args.slots} slots, chunk={args.chunk}, slot utilisation {util:.0%}{extra})")
        if prefix_cache is not None:
            st = prefix_cache.stats()
            print(f"prefix cache: {st['hits']} hits / {st['misses']} misses, {st['commits']} commits, "
                  f"{st['evictions']} evictions, {st['cached_bytes'] / 2**20:.2f} MiB cached "
                  f"({st['nodes']} blocks)")
        sample = done[0].new_tokens
    print("kernel launches:", launch_counts())
    print("sample:", sample)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "serve_profile.json")
        profiler.export_chrome_trace(path)
        print(f"profile: {path} (torch.profiler Chrome trace; open in ui.perfetto.dev)")
    if tracer is not None:
        with open(args.trace_out, "w") as f:
            json.dump(tracer.to_chrome(), f)
        st = tracer.stats()
        print(f"trace: {args.trace_out} ({st['buffered']} events, {st['evicted']} evicted) — "
              f"open in ui.perfetto.dev")
        if not args.sequential:
            counters = {name: sum(s["value"] for s in fam["series"])
                        for name, fam in registry.snapshot().items() if fam["type"] == "counter"}
            print("metrics:", json.dumps(counters, sort_keys=True))


if __name__ == "__main__":
    main()
