"""Serving launcher: quantize, then serve requests one at a time through
``Engine.generate`` (counterpart of ``repro/launch/serve.py``).

PYTHONPATH=src python -m repro_torch.launch.serve --sequential
PYTHONPATH=src python -m repro_torch.launch.serve --sequential --device cpu

The model is the reference launcher's reduced config of ``--arch`` (d_model
256, 4 kv heads, d_ff 512, 2 layers, vocab 256, f32), with random weights
from seed 0, quantized with ``--q``/``--g`` in ``--format`` (``--q 0``
serves it dense). ``--format`` takes every registered format: ``bcq``,
``uniform``, ``dequant``, ``ternary`` (always 2 planes, whatever ``--q``
says) and ``codebook``; on the GPU each serves through its own kernel.
Requests come from the same Markov corpus and seeds as the reference's,
with temperatures cycling 0, 1.0, 0.7.

Only ``--sequential`` serving is ported. The continuous-batching scheduler
(``--slots``, ``--chunk``), ``--speculate``, ``--tp``, the prefix cache
(``--prefix-cache-mb``, ``--prefix-block``, ``--shared-prefix-len``),
chunked prefill and the tracing / profiling flags belong to subsystems that
are not ported yet; each is refused with an error naming the missing piece.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.formats import format_names
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import init_params, reduced
from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0


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
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s (0 = all at t=0)")
    ap.add_argument("--sequential", action="store_true",
                    help="serve with one generate call per request (the only "
                         "mode ported so far)")
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
        (args.slots is not None, "--slots sets the continuous mode's batch width; the scheduler "
                                 "(infer/scheduler.py) is not ported yet"),
        (args.chunk is not None, "--chunk sets the scheduler's dispatch length; the scheduler "
                                 "(infer/scheduler.py) is not ported yet"),
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
        (not args.sequential, "the default continuous mode needs the scheduler "
                              "(infer/scheduler.py), not ported yet; pass --sequential"),
    ]
    for bad, msg in missing:
        if bad:
            ap.error(msg)

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
    outs, dt = drive_sequential(engine, reqs, arrivals)
    print(f"[sequential] {len(outs)} requests, {total_new} tokens in "
          f"{dt:.2f}s ({total_new/dt:.1f} tok/s on {engine.device})")
    print("kernel launches:", launch_counts())
    print("sample:", outs[0].tokens[0, args.prompt_len:])


if __name__ == "__main__":
    main()
