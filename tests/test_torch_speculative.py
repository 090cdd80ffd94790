"""The port's self-speculative decoding, the mirror of
``tests/test_speculative.py``, with the JAX package's speculative code as
the oracle on the same weights (reduced llama3.2-3b in f32, carried across
through numpy): speculative greedy tokens equal the JAX package's and the
port's own plain greedy tokens, with the same proposed and accepted counts;
the chunked verify forward is within 2e-5 of JAX's and bit for bit the
port's step-by-step decode; a rejected chunk leaves no trace in a linear
cache; the speculative scheduler keeps greedy and opted-out requests
identical to their solo plain ``generate``; rejection sampling keeps the
target's distribution; and validation.

Not mirrored: the ring-window and recurrent cases (those families are not
ported; the engine refuses them, held below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.infer import SpecConfig as JSpecConfig
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, Request, Scheduler, SpecConfig
from repro_torch.infer import speculative as S
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, reduced
from repro_torch.quant import QuantPolicy, quantize_params, truncate_params
from repro_torch.utils import tree_leaves
from torch_helpers import jax_tree_to_numpy

TOL = 2e-5
SIZES = dict(d_model=128, d_ff=256, vocab=512, n_kv_heads=2)  # the reference test's _quantizable
KEY = jax.random.PRNGKey(0)
POLICIES = {
    "dense": None,
    "bcq_q4": JPolicy(q=4, g=64, method="greedy"),
    "low_acceptance": JPolicy(q=4, g=64, iters=2),
}


def _cfgs(**overrides):
    sizes = dict(SIZES, **overrides)
    return jreduced(jget_config("llama3.2-3b"), **sizes), reduced(get_config("llama3.2-3b"), **sizes)


@pytest.fixture(scope="module")
def models():
    """name → (JAX config, JAX params, port config, port params) on the same weights."""
    jcfg, tcfg = _cfgs()
    out = {}
    for name, pol in POLICIES.items():
        jp = jinit_params(KEY, jcfg)
        if pol is not None:
            jp = jquantize_params(jp, pol)
        out[name] = (jcfg, jp, tcfg, params_from_numpy(jax_tree_to_numpy(jp), device="cpu"))
    return out


def _prompts(vocab, b, plen, seed=7):
    return MarkovCorpus(vocab, seed=3).sample(b, plen, seed=seed).astype(np.int32)[:, :plen]


def _port_engine(models, name, max_seq=64):
    _, _, tcfg, tp = models[name]
    return Engine(tcfg, tp, max_seq=max_seq, device="cpu")


# ---------------------------------------------------------------------------
# greedy exactness, against the port's plain path and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,b,q_draft", [("dense", 2, 2), ("bcq_q4", 2, 2), ("low_acceptance", 1, 1)])
def test_spec_generate_matches_jax_and_plain(models, name, b, q_draft):
    """Speculative greedy tokens equal the port's plain greedy tokens and the
    JAX package's speculative tokens, with the JAX package's proposed,
    accepted and chunk counts (its plain tokens equal the port's here: no
    step of these prompts is a near tie)."""
    jcfg, jp, _, _ = models[name]
    jeng, eng = JEngine(jcfg, jp, max_seq=64), _port_engine(models, name)
    prompts = _prompts(jcfg.vocab, b, 8)
    plain = eng.generate(prompts, 16)
    spec = eng.generate(prompts, 16, speculate=SpecConfig(q_draft=q_draft, gamma=4))
    np.testing.assert_array_equal(spec.tokens, plain.tokens)
    jplain = jeng.generate(prompts, 16)
    jspec = jeng.generate(prompts, 16, speculate=JSpecConfig(q_draft=q_draft, gamma=4))
    np.testing.assert_array_equal(plain.tokens, jplain.tokens)
    np.testing.assert_array_equal(spec.tokens, jspec.tokens)
    for key in ("proposed", "accepted", "chunks", "q_draft", "gamma"):
        assert spec.spec_stats[key] == jspec.spec_stats[key], key
    assert spec.spec_stats["accept_rate"] == pytest.approx(jspec.spec_stats["accept_rate"])
    if name == "dense":
        assert spec.spec_stats["accept_rate"] == 1.0  # the draft is the target
    if name == "low_acceptance":
        assert spec.spec_stats["accept_rate"] < 0.9  # the 1-plane draft really is worse


def test_spec_generate_ternary_equals_plain():
    """Ternary: the draft is the 1-plane BCQ view (``as_bcq``'s first plane),
    the verify the ternary weights; greedy output equals plain greedy."""
    _, tcfg = _cfgs()
    params = quantize_params(init_params(tcfg, seed=0, device="cpu"),
                             QuantPolicy(q=2, g=64, iters=2, fmt="ternary"), device="cpu")
    eng = Engine(tcfg, params, max_seq=64, device="cpu")
    draft = eng.draft_params(1)
    fmts = {(leaf.fmt, leaf.q) for leaf in tree_leaves(draft) if isinstance(leaf, QuantizedTensor)}
    assert fmts == {("bcq", 1)}
    prompts = _prompts(tcfg.vocab, 2, 8)
    spec = eng.generate(prompts, 12, speculate=SpecConfig(1, 4))
    np.testing.assert_array_equal(spec.tokens, eng.generate(prompts, 12).tokens)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_spec_generate_reproducible_and_budgeted(models, temperature):
    """A seed reproduces a speculative run; every row gets exactly n_steps
    tokens in the vocabulary whatever each chunk committed."""
    eng = _port_engine(models, "bcq_q4")
    prompts = _prompts(SIZES["vocab"], 3, 6)
    runs = [eng.generate(prompts, 11, temperature=temperature, seed=4, speculate=SpecConfig(2, 3))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0].tokens, runs[1].tokens)
    assert runs[0].tokens.shape == (3, 17) and ((runs[0].tokens >= 0) & (runs[0].tokens < SIZES["vocab"])).all()
    assert runs[0].spec_stats["chunks"] >= 1


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------


def test_chunked_forward_matches_jax_and_step_decode(models):
    """Feeding 6 tokens chunked against a filled cache: logits within 2e-5 of
    the JAX package's ``forward(chunked_decode=True)``, and bit for bit the
    port's 6 single-token decode steps."""
    jcfg, jp, tcfg, tp = models["bcq_q4"]
    toks = _prompts(jcfg.vocab, 2, 26)
    prompt, rest = toks[:, :20], toks[:, 20:]

    jcache = jinit_cache(jcfg, 2, 40)
    _, jcache, _ = jforward(jcfg, jp, tokens=jnp.asarray(prompt), cache=jcache, pos=jnp.int32(0),
                            logits_mode="last")
    jchunk, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(rest), cache=jcache,
                            pos=jnp.full((2,), 20, jnp.int32), logits_mode="all", chunked_decode=True)

    def filled():
        cache = init_cache(tcfg, 2, 40, device="cpu")
        _, cache = forward(tcfg, tp, tokens=torch.as_tensor(prompt).long(), cache=cache, pos=0,
                           logits_mode="last")
        return cache

    chunk, _ = forward(tcfg, tp, tokens=torch.as_tensor(rest).long(), cache=filled(),
                       pos=torch.full((2,), 20), logits_mode="all", chunked_decode=True)
    cache, steps = filled(), []
    for t in range(rest.shape[1]):
        lg, cache = forward(tcfg, tp, tokens=torch.as_tensor(rest[:, t : t + 1]).long(), cache=cache,
                            pos=torch.full((2,), 20 + t), logits_mode="last")
        steps.append(lg[:, 0])
    assert torch.equal(chunk, torch.stack(steps, dim=1))
    np.testing.assert_allclose(chunk.numpy(), np.asarray(jchunk), rtol=TOL, atol=TOL)


def test_rejected_chunk_leaves_no_trace(models):
    """A junk chunk through the verify path, then fully rejected (the
    position not advanced): the next real step's logits are bit for bit
    those of never having decoded it. Linear caches need no row restore."""
    _, _, tcfg, tp = models["bcq_q4"]
    prompts = _prompts(tcfg.vocab, 2, 20)
    pos = torch.full((2,), 20)

    def filled():
        cache = init_cache(tcfg, 2, 40, device="cpu")
        return forward(tcfg, tp, tokens=torch.as_tensor(prompts).long(), cache=cache, pos=0,
                       logits_mode="last")[1]

    clean, dirty = filled(), filled()
    junk = torch.tensor([[3, 5, 7, 11], [13, 2, 4, 8]])
    forward(tcfg, tp, tokens=junk, cache=dirty, pos=pos, logits_mode="all", chunked_decode=True)
    tok = torch.as_tensor(_prompts(tcfg.vocab, 2, 21, seed=9)[:, -1:]).long()
    want, _ = forward(tcfg, tp, tokens=tok, cache=clean, pos=pos, logits_mode="last")
    got, _ = forward(tcfg, tp, tokens=tok, cache=dirty, pos=pos, logits_mode="last")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# speculative continuous batching
# ---------------------------------------------------------------------------


def test_spec_scheduler_token_identical(models):
    """Speculative slots: greedy rows and per-request opt-outs (sampled ones
    included, whose stream must be the plain one bit for bit) equal solo
    plain ``generate``; every budget exact."""
    eng = _port_engine(models, "bcq_q4")
    corpus = MarkovCorpus(SIZES["vocab"], seed=3)
    rng = np.random.default_rng(0)
    reqs = []
    for i, (temp, spec_in) in enumerate(
        [(0.0, True), (1.0, False), (0.0, True), (0.7, False), (0.0, False), (1.0, True)]
    ):
        plen = int(rng.integers(4, 10))
        reqs.append(Request(prompt=corpus.sample(1, plen, seed=100 + i)[0, :plen].astype(np.int32),
                            max_new_tokens=int(rng.integers(3, 12)), temperature=temp, seed=10 + i,
                            speculate=spec_in))
    sched = Scheduler(eng, n_slots=3, chunk=2, speculate=SpecConfig(q_draft=2, gamma=3))
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    assert len(done) == len(reqs)
    assert 0.0 <= sched.spec_accept_rate <= 1.0 and sched.chunk_rows > 0
    for r in reqs:
        assert done[r.rid].new_tokens.shape == (r.max_new_tokens,)
        if r.temperature == 0.0 or r.speculate is False:
            solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
            np.testing.assert_array_equal(solo.tokens[0, r.prompt.size :], done[r.rid].new_tokens,
                                          err_msg=f"request {r.rid} diverged from solo plain generate")


def test_spec_scheduler_budget_one_completes_at_admission(models):
    """The first token is emitted at admission: a budget-1 request completes
    at once and frees its slot in the same round."""
    eng = _port_engine(models, "dense", max_seq=48)
    corpus = MarkovCorpus(SIZES["vocab"], seed=3)
    sched = Scheduler(eng, n_slots=1, chunk=2, speculate=SpecConfig(2, 2))
    p = corpus.sample(1, 5, seed=1)[0, :5].astype(np.int32)
    a = sched.submit(Request(prompt=p, max_new_tokens=1))
    b = sched.submit(Request(prompt=p, max_new_tokens=4))
    first = sched.step()
    assert first[0].rid == a and first[0].finished_at_step == 0  # done at admission, before any chunk
    done = {c.rid: c for c in first + sched.run()}
    assert done[a].new_tokens.shape == (1,) and done[b].new_tokens.shape == (4,)
    solo = eng.generate(p[None], 4)
    np.testing.assert_array_equal(solo.tokens[0, 5:6], done[a].new_tokens)
    np.testing.assert_array_equal(solo.tokens[0, 5:], done[b].new_tokens)


def test_spec_chunk_failure_midway_retry_is_exact(models, monkeypatch):
    """A speculative dispatch that raises after one of its chunks ran leaves
    positions, budgets, pending tokens and every generator as they were, so
    the retried dispatch emits what an undisturbed run emits."""
    eng = _port_engine(models, "bcq_q4")
    spec = SpecConfig(2, 2)

    def requests():
        corpus = MarkovCorpus(SIZES["vocab"], seed=3)
        return [Request(prompt=corpus.sample(1, 5, seed=100 + i)[0, :5].astype(np.int32), max_new_tokens=9,
                        temperature=[1.0, 0.0, 0.7][i], seed=20 + i) for i in range(3)]

    ref = Scheduler(eng, n_slots=3, chunk=2, speculate=spec)
    ref_rids = [ref.submit(r) for r in requests()]
    ref_done = {c.rid: c for c in ref.run()}
    real, calls = S.spec_chunk, [0]

    def flaky(*args, **kw):
        calls[0] += 1
        if calls[0] == 4:  # the second chunk of the second dispatch
            raise RuntimeError("device fault mid-dispatch")
        return real(*args, **kw)

    monkeypatch.setattr("repro_torch.infer.engine.spec_chunk", flaky)
    sched = Scheduler(eng, n_slots=3, chunk=2, speculate=spec, retries=1, sleep=lambda s: None)
    rids = [sched.submit(r) for r in requests()]
    done = {c.rid: c for c in sched.run()}
    assert sched.counters["retries"] == 1
    for r0, r1 in zip(ref_rids, rids):
        np.testing.assert_array_equal(done[r1].new_tokens, ref_done[r0].new_tokens)


# ---------------------------------------------------------------------------
# rejection sampling keeps the target's distribution
# ---------------------------------------------------------------------------


def test_spec_sampling_preserves_target_distribution():
    """The token after the first speculative chunk, over 1024 rows of one
    prompt (per-row streams), has the plain sampled marginal: total
    variation < 0.10 at vocab 16."""
    _, tcfg = _cfgs(vocab=16)
    params = quantize_params(init_params(tcfg, seed=0, device="cpu"), QuantPolicy(q=4, g=64, iters=2),
                             device="cpu")
    eng = Engine(tcfg, params, max_seq=32, device="cpu")
    n = 1024
    prompts = np.tile(_prompts(tcfg.vocab, 1, 6), (n, 1))
    plain = eng.generate(prompts, 2, temperature=1.0, seed=5)
    spec = eng.generate(prompts, 2, temperature=1.0, seed=5, speculate=SpecConfig(q_draft=1, gamma=2))
    assert 0.0 < spec.spec_stats["accept_rate"] < 1.0  # both accepts and rejections
    p_hist = np.bincount(plain.tokens[:, 7], minlength=tcfg.vocab) / n
    s_hist = np.bincount(spec.tokens[:, 7], minlength=tcfg.vocab) / n
    tv = 0.5 * np.abs(p_hist - s_hist).sum()
    assert tv < 0.10, f"total variation {tv:.3f} too large for n={n}"


# ---------------------------------------------------------------------------
# draft view and validation
# ---------------------------------------------------------------------------


def test_draft_params_are_views_of_the_target(models):
    """The draft shares every unquantized leaf and the target's plane storage
    (no copy), each layer's slice contiguous; it is cached per q'."""
    eng = _port_engine(models, "bcq_q4")
    draft = eng.draft_params(2)
    assert eng.draft_params(2) is draft
    pairs = list(zip(tree_leaves(eng.params), tree_leaves(draft)))
    n_qt = 0
    for full, cut in pairs:
        if isinstance(full, QuantizedTensor):
            n_qt += 1
            assert (full.q, cut.q) == (4, 2)
            assert cut.packed.data_ptr() == full.packed.data_ptr()
            layer = cut.packed if cut.packed.dim() == 3 else cut.packed[1]
            assert layer.is_contiguous()
            assert torch.equal(cut.packed, full.packed[..., :2, :, :])
        else:
            assert cut is full
    assert n_qt == 5  # wqkv, wo, w_gate_up, w_down, lm_head
    for full, cut in zip(tree_leaves(eng.params), tree_leaves(truncate_params(eng.params, 9))):
        if isinstance(full, QuantizedTensor):
            assert cut.q == full.q


def test_spec_validation(models):
    with pytest.raises(ValueError):
        SpecConfig(q_draft=0, gamma=4)
    with pytest.raises(ValueError):
        SpecConfig(q_draft=2, gamma=0)
    assert SpecConfig.parse("2:4") == SpecConfig(q_draft=2, gamma=4)
    for bad in ("nope", "2", "2:0", "a:b"):
        with pytest.raises(ValueError, match="QD:GAMMA"):
            SpecConfig.parse(bad)

    eng = _port_engine(models, "bcq_q4", max_seq=16)
    prompts = _prompts(SIZES["vocab"], 1, 8)
    with pytest.raises(ValueError, match="gamma"):  # prompt + n_steps + gamma must fit
        eng.generate(prompts, 8, speculate=SpecConfig(2, 4))
    with pytest.raises(ValueError, match="SpecConfig"):
        eng.generate(prompts, 2, speculate="2:4")

    _, tcfg = _cfgs()
    uni = Engine(tcfg, quantize_params(init_params(tcfg, seed=0, device="cpu"),
                                       QuantPolicy(q=4, g=64, iters=2, fmt="uniform"), device="cpu"),
                 max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="truncation-capable formats: \\['bcq', 'ternary'\\]"):
        uni.generate(prompts, 2, speculate=SpecConfig(2, 2))
    with pytest.raises(ValueError, match="truncation-capable"):
        Scheduler(uni, n_slots=2, speculate=SpecConfig(2, 2))

    # a ring-window model needs the rollback that comes with that family
    ring = _port_engine(models, "dense")
    ring.cfg = dataclasses.replace(ring.cfg, stages=((("local_attn",), 2),))
    with pytest.raises(ValueError, match="restore_rows"):
        ring.generate(prompts, 2, speculate=SpecConfig(2, 2))
    ring.cfg = dataclasses.replace(ring.cfg, stages=((("rglru",), 2),))
    with pytest.raises(ValueError, match="recurrent"):
        ring.generate(prompts, 2, speculate=SpecConfig(2, 2))

    # the scheduler keeps gamma + 1 rows of headroom
    sched = Scheduler(_port_engine(models, "bcq_q4", max_seq=16), n_slots=1, speculate=SpecConfig(2, 4))
    with pytest.raises(ValueError, match="headroom"):
        sched.submit(Request(prompt=np.zeros((6,), np.int32), max_new_tokens=6))
    with pytest.raises(ValueError, match="speculate=..."):
        _port_engine(models, "bcq_q4").spec_decode_slots(_port_engine(models, "bcq_q4").init_slots(1), 1)


@pytest.mark.parametrize("argv,message", [
    (["--speculate", "2:4", "--format", "uniform"], "truncation-capable formats: bcq, ternary"),
    (["--speculate", "2x4"], "QD:GAMMA"),
])
def test_serve_cli_speculate_errors(capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_serve_cli_speculative_on_cpu(capsys):
    serve.main(["--speculate", "2:3", "--device", "cpu", "--requests", "3", "--gen", "5",
                "--prompt-len", "6", "--q", "4", "--g", "64", "--slots", "2", "--chunk", "2"])
    out = capsys.readouterr().out
    assert "[speculative q'=2 γ=3] 3 requests, 15 tokens" in out
    assert "draft acceptance" in out and "sample:" in out
