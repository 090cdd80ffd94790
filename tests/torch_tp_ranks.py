"""The serving scenarios of ``tests/test_torch_tp_serve.py``, run in each
spawned rank of a tensor-parallel group and, with ``mesh=None``, in the
test process itself as the single-device reference. This module imports
nothing of JAX, so the ranks never load it.

Every scenario takes ``(cfg, params, mesh)`` (``params`` a numpy tree, as
``models.params_from_numpy`` takes it) and returns numpy values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, PrefixCache, Request, Scheduler, SpecConfig
from repro_torch.models import params_from_numpy, reduced
from repro_torch.parallel import collective_counts, make_tp_mesh, reset_collective_counts

SIZES = dict(d_model=128, n_kv_heads=4, d_ff=256)
N_STEPS = 8
MAX_SEQ = 48


def config():
    return reduced(get_config("llama3.2-3b"), **SIZES)


def prompts():
    return MarkovCorpus(config().vocab, seed=3).sample(2, 6, seed=1).astype(np.int32)


def engine(params, mesh, *, fuse=True, prefix_cache=None):
    return Engine(config(), params_from_numpy(params, device="cpu"), max_seq=MAX_SEQ, device="cpu", fuse=fuse,
                  mesh=mesh, prefix_cache=prefix_cache)


def greedy_requests(n):
    corpus = MarkovCorpus(config().vocab, seed=9)
    lens, buds = [4, 6, 4, 6, 5], [5, 7, 7, 5, 7]
    return [Request(prompt=corpus.sample(1, lens[i], seed=50 + i)[0].astype(np.int32), max_new_tokens=buds[i])
            for i in range(n)]


def shared_prefix_requests(n, prefix_len=12, gen=6):
    """The reference prefix-cache test's workload: a shared 12-token prompt,
    tails of 2..5 tokens, temperatures cycling 0, 1.0, 0.7."""
    corpus = MarkovCorpus(config().vocab, seed=3)
    shared = corpus.sample(1, prefix_len, seed=99)[0, :prefix_len]
    out = []
    for i in range(n):
        tlen = 2 + (i % 4)
        tail = corpus.sample(1, tlen, seed=100 + i)[0, :tlen]
        out.append(Request(prompt=np.concatenate([shared, tail]).astype(np.int32), max_new_tokens=gen,
                           temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i))
    return out


def run_scheduler(eng, reqs, **kw):
    sched = Scheduler(eng, **kw)
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    return [np.asarray(done[r.rid].new_tokens) for r in reqs]


# -- scenarios -----------------------------------------------------------------


def greedy(params, mesh, fuse=True, scan=True):
    """Greedy tokens; the collectives of one prefill forward; whether the
    decode replayed a captured graph."""
    eng = engine(params, mesh, fuse=fuse)
    out = eng.generate(prompts(), N_STEPS, scan=scan)
    reset_collective_counts()
    eng.prefill(torch.as_tensor(prompts()).long(), eng._make_cache(2))
    return {"tokens": out.tokens, "captured": out.captured, "collectives": collective_counts()}


def logits(params, mesh):
    """Prefill logits and one decode step's, as the reference's logits test."""
    eng = engine(params, mesh)
    pre, cache = eng.prefill(torch.as_tensor(prompts()).long(), eng._make_cache(2))
    dec, _ = eng.decode(torch.tensor([[3], [5]]), cache, 6)
    return {"prefill": pre.numpy(), "decode": dec.numpy()}


def sampled(params, mesh):
    eng = engine(params, mesh)
    return [eng.generate(prompts(), N_STEPS, temperature=0.7, seed=11).tokens for _ in range(2)]


def solos(params, mesh, n=5):
    eng = engine(params, mesh)
    return [eng.generate(r.prompt[None], r.max_new_tokens).tokens[0, r.prompt.size:] for r in greedy_requests(n)]


def slots(params, mesh):
    """5 greedy requests through 2 slots, chunk 3 (mid-flight admissions)."""
    return run_scheduler(engine(params, mesh), greedy_requests(5), n_slots=2, chunk=3)


def mixed(params, mesh):
    """Mixed temperatures through the slots and solo, on one engine."""
    eng = engine(params, mesh)
    reqs = greedy_requests(4)
    for i, r in enumerate(reqs):
        r.temperature, r.seed = [0.0, 1.0, 0.7, 0.0][i], 20 + i
    got = run_scheduler(eng, reqs, n_slots=2, chunk=3)
    solo = [eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
            .tokens[0, r.prompt.size:] for r in reqs]
    return {"slots": got, "solo": solo}


def speculative(params, mesh, q_draft, gamma=2):
    out = engine(params, mesh).generate(prompts(), N_STEPS, speculate=SpecConfig(q_draft=q_draft, gamma=gamma))
    return {"tokens": out.tokens, "chunks": out.spec_stats["chunks"]}


def spec_slots(params, mesh):
    return run_scheduler(engine(params, mesh), greedy_requests(4), n_slots=2, chunk=2,
                         speculate=SpecConfig(q_draft=2, gamma=2))


def warm_cold(params, mesh, spec=None):
    """The reference GRID's warm-vs-cold run: wave 1 fills the cache, wave 2
    (identical prompts) runs warm, a cold engine runs the same wave; and one
    solo generate of the first request."""
    warm = engine(params, mesh, prefix_cache=PrefixCache(block_tokens=4, max_bytes=64 << 20))
    run_scheduler(warm, shared_prefix_requests(5), n_slots=2, chunk=3, speculate=spec)
    hits = warm.prefix_cache.counters["hits"]
    reqs = shared_prefix_requests(5)
    warm_tokens = run_scheduler(warm, reqs, n_slots=2, chunk=3, speculate=spec)
    counters = dict(warm.prefix_cache.counters)
    cold = engine(params, mesh)
    cold_tokens = run_scheduler(cold, shared_prefix_requests(5), n_slots=2, chunk=3, speculate=spec)
    solo = cold.generate(reqs[0].prompt[None], reqs[0].max_new_tokens, speculate=spec)
    return {"warm": warm_tokens, "cold": cold_tokens, "solo": solo.tokens[0, reqs[0].prompt.size:],
            "hits_before": hits, "counters": counters, "pinned": warm.prefix_cache.pinned}


SCENARIOS = {f.__name__: f for f in (greedy, logits, sampled, solos, slots, mixed, speculative, spec_slots,
                                     warm_cold)}


def run_cases(cases, params, mesh):
    """``cases``: {name: (scenario, params key, kwargs)} → {name: result}."""
    return {name: SCENARIOS[fn](params[key], mesh, **kw) for name, (fn, key, kw) in cases.items()}


def rank_main(rank, n, cases, params):
    """One rank of an ``n``-way group: every case on this rank's shards."""
    torch.set_num_threads(1)
    return run_cases(cases, params, make_tp_mesh(n))


def cuda_rank(rank, n, cfg, path, prompts_):
    """One rank of the card's test (``tests/test_torch_cuda.py``): the
    weights saved at ``path`` split over ``n`` ranks sharing the card."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    eng = Engine(cfg, torch.load(path, map_location="cpu", mmap=True, weights_only=False), max_seq=64,
                 device="cuda", mesh=make_tp_mesh(n))
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_collective_counts()
    res = eng.generate(prompts_, N_STEPS)
    out = dict(tokens=res.tokens, captured=res.captured, launches=launch_counts(), collectives=collective_counts())
    toks = torch.as_tensor(prompts_, device=eng.device).long()
    pre, cache = eng.prefill(toks, eng._make_cache(len(prompts_)))
    dec, _ = eng.decode(toks[:, -1:], cache, toks.shape[1])
    out["logits"] = torch.stack([pre, dec]).cpu().numpy()
    out["spec"] = eng.generate(prompts_, N_STEPS, speculate=SpecConfig(q_draft=2, gamma=2)).tokens
    out["slots"] = run_scheduler(eng, greedy_requests(5), n_slots=2, chunk=3)
    out["solos"] = [eng.generate(r.prompt[None], r.max_new_tokens).tokens[0, r.prompt.size:]
                    for r in greedy_requests(5)]
    return out


def failing_rank(rank, n):
    """Rank 1 raises; the others wait for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hanging_rank(rank, n):
    """Rank 0 never returns."""
    import time

    while rank == 0:
        time.sleep(1)


def collective_sizes(rank, n, batch, seq):
    """One prefill forward and one decode step of ``config()`` (random
    weights from seed 0) in each of ``n`` TP ranks → the collectives each
    issued, by kind: counts and result bytes (``parallel/ctx.py``)."""
    from repro_torch.models import init_params
    from repro_torch.parallel import collective_bytes

    eng = Engine(config(), init_params(config(), seed=0, device="cpu"), max_seq=MAX_SEQ, device="cpu",
                 mesh=make_tp_mesh(n))
    out = {}
    cache = eng._make_cache(batch)
    reset_collective_counts()
    _, cache = eng.prefill(torch.zeros((batch, seq), dtype=torch.long), cache)
    out["prefill"] = (collective_counts(), collective_bytes())
    reset_collective_counts()
    eng.decode(torch.zeros((batch, 1), dtype=torch.long), cache, seq)
    out["decode"] = (collective_counts(), collective_bytes())
    return out
