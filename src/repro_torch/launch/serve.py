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

``--speculate``, ``--tp``, the prefix cache (``--prefix-cache-mb``,
``--prefix-block``, ``--shared-prefix-len``), chunked prefill
(``--prefill-chunk``) and the tracing / profiling flags belong to
subsystems that are not ported yet; each is refused with an error naming
the missing piece.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.formats import format_names
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, Request, Scheduler
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import init_params, reduced
from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes


def build_requests(cfg, n, prompt_len, gen, *, mixed_temperature=True, seed=3):
    """``n`` requests with prompts from the Markov corpus; temperatures cycle
    0, 1.0, 0.7 unless ``mixed_temperature`` is False (all greedy)."""
    corpus = MarkovCorpus(cfg.vocab, seed=seed)
    reqs = []
    for i in range(n):
        prompt = corpus.sample(1, prompt_len, seed=100 + i)[0, :prompt_len]
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


def drive_continuous(engine, reqs, arrivals, *, n_slots, chunk):
    """Wall-clock serve loop: submit each request at its arrival offset,
    step the scheduler whenever there is work. Returns (scheduler,
    completions, makespan seconds); the scheduler carries the utilisation
    counters and the lifecycle summary."""
    sched = Scheduler(engine, n_slots=n_slots, chunk=chunk)
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
    ap.add_argument("--prefix-cache-mb", type=int, default=0)
    ap.add_argument("--prefix-block", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--shared-prefix-len", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH")
    ap.add_argument("--profile-dir", type=str, default=None, metavar="DIR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)

    missing = [
        (args.prefix_block is not None, "--prefix-block needs the prefix cache (infer/prefix_cache.py), "
                                        "not ported yet"),
        (args.shared_prefix_len is not None, "--shared-prefix-len is the prefix cache's workload; the "
                                             "prefix cache (infer/prefix_cache.py) is not ported yet"),
        (args.speculate, "--speculate needs self-speculative decoding (infer/speculative.py), not ported yet"),
        (args.tp != 1, "--tp needs tensor parallelism (parallel/tp.py), not ported yet"),
        (args.prefix_cache_mb, "--prefix-cache-mb needs the prefix cache (infer/prefix_cache.py), not ported yet"),
        (args.prefill_chunk, "--prefill-chunk needs chunked prefill in the scheduler, not ported yet"),
        (args.trace_out, "--trace-out needs the span tracer (repro.obs), not ported yet"),
        (args.profile_dir, "--profile-dir needs the profiler hooks (repro.obs), not ported yet"),
    ]
    for bad, msg in missing:
        if bad:
            ap.error(msg)
    if args.slots < 1 or args.chunk < 1:
        ap.error("--slots and --chunk must be >= 1")

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
    engine = Engine(cfg, params, max_seq=args.prompt_len + args.gen + 8,
                    device=args.device)
    del params  # the engine holds the fused layout
    reqs = build_requests(cfg, args.requests, args.prompt_len, args.gen)
    arrivals = poisson_arrivals(args.requests, args.rate, seed=1)
    total_new = sum(r.max_new_tokens for r in reqs)

    reset_launch_counts()
    if args.sequential:
        outs, dt = drive_sequential(engine, reqs, arrivals)
        print(f"[sequential] {len(outs)} requests, {total_new} tokens in "
              f"{dt:.2f}s ({total_new/dt:.1f} tok/s on {engine.device})")
        sample = outs[0].tokens[0, args.prompt_len:]
    else:
        sched, done, dt = drive_continuous(engine, reqs, arrivals, n_slots=args.slots,
                                           chunk=args.chunk)
        util = sched.steps_active / max(1, sched.decode_steps * sched.n_slots)
        print(f"[continuous] {len(done)} requests, {total_new} tokens in "
              f"{dt:.2f}s ({total_new/dt:.1f} tok/s on {engine.device}, "
              f"{args.slots} slots, chunk={args.chunk}, slot utilisation {util:.0%})")
        sample = done[0].new_tokens
    print("kernel launches:", launch_counts())
    print("sample:", sample)


if __name__ == "__main__":
    main()
