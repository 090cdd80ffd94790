"""The captured decode step (``infer/graphs.py``, the port's counterpart of
the reference's ``_scan_decode`` / ``_scan_decode_slots``), on the CPU at
a reduced size (2 layers, d_model 128, 4 kv heads, f32), with the bf16 and
the int8 cache layouts.

A CPU cannot capture, so a :class:`DecodeGraph` runs its step eagerly on
its static buffers here; what a capture would freeze is held directly:

- a scalar position and a ``(B,)`` tensor of the same value give the same
  bits (the captured step takes the ``(B,)`` paths), and every scalar path
  raises while a capture is reported;
- the static-buffer step equals ``Engine.decode``; a reused, re-zeroed
  engine cache gives a fresh cache's tokens; an engine keeps the cache and
  graphs of one width, one graph per impl mode, and a graph refuses
  another mode;
- the launch census: a capture's counts are taken back and added once per
  replay;
- a graph's workspace cannot grow once frozen.

Replays on the card: ``tests/test_torch_cuda.py`` (``-k graph``).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.infer import Engine, Request, Scheduler
from repro_torch.infer import engine as engine_mod
from repro_torch.infer.graphs import DecodeGraph, counted
from repro_torch.kernels import (
    add_counters,
    bcq_mm,
    counters,
    impl_mode,
    launch_counts,
    lutgemm,
    qmatmul,
    reset_launch_counts,
)
from repro_torch.kernels import _common
from repro_torch.models import forward, init_cache, init_params, reduced
from repro_torch.models import layers as L
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.utils import tree_leaves
import torch_helpers  # noqa: F401  (one torch thread per test worker)

SIZES = dict(d_model=128, n_kv_heads=4)
KV = ["bfloat16", "int8"]
B, P = 3, 7  # batch, prompt length


def _cfg(kv):
    return reduced(get_config("llama3.2-3b"), **SIZES, kv_cache_dtype=kv)


@pytest.fixture(scope="module")
def params():
    return init_params(_cfg("bfloat16"), seed=0, device="cpu")


def _engine(kv, params, **kw):
    return Engine(_cfg(kv), params, max_seq=32, device="cpu", **kw)


def _prompts(seed=0, b=B):
    return np.random.default_rng(seed).integers(0, 256, size=(b, P)).astype(np.int32)


def _caches_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("mode", ["decode", "verify"])
def test_scalar_and_row_positions_give_the_same_bits(params, kv, mode):
    """Decode steps (one token) or a chunked verify (three) at a scalar
    position and at a ``(B,)`` tensor of it: the same logits and the same
    cache, bit for bit."""
    cfg = _cfg(kv)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(B, P + 6))).long()
    out = {}
    for per_row in (False, True):
        cache = init_cache(cfg, B, 16, device="cpu")
        with torch.no_grad():
            forward(cfg, params, tokens=toks[:, :P], cache=cache, pos=0, logits_mode="last", prefill=True)
            logits = []
            width = 1 if mode == "decode" else 3
            for start in range(P, P + 6, width):
                pos = torch.full((B,), start) if per_row else start
                lg, cache = forward(cfg, params, tokens=toks[:, start : start + width], cache=cache, pos=pos,
                                    logits_mode="all", chunked_decode=mode == "verify")
                logits.append(lg)
        out[per_row] = (torch.cat(logits, dim=1), cache)
    assert torch.equal(out[False][0], out[True][0])
    assert _caches_equal(out[False][1], out[True][1])


@pytest.mark.parametrize("kv", KV)
def test_static_buffer_step_equals_engine_decode(params, kv):
    """The graph's step function, run eagerly on its static buffers, gives
    ``Engine.decode``'s logits and writes the same cache."""
    eng = _engine(kv, params)
    prompts = torch.as_tensor(_prompts()).long()
    logits, cache = eng.prefill(prompts, eng._make_cache(B))
    twin = [leaf.clone() for leaf in tree_leaves(cache)]
    graph = DecodeGraph(eng.cfg, eng.params, cache, B)
    eager_cache = eng._make_cache(B)
    for leaf, src in zip(tree_leaves(eager_cache), twin):
        leaf.copy_(src)
    for step in range(4):
        tok = torch.argmax(logits, dim=-1)
        got = graph(tok, P + step)
        logits, eager_cache = eng.decode(tok[:, None], eager_cache, P + step)
        assert torch.equal(got, logits)
        assert _caches_equal(graph.cache, eager_cache)
    assert graph.graph is None and graph.replays == 0  # the CPU does not capture


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_reused_zeroed_cache_gives_fresh_tokens(params, kv, temperature):
    """``generate(scan=True)`` reuses its cache at one width and zeroes it
    each call: runs on other prompts in between, and at another width (which
    replaces the cache and graph), leave no trace, and every run equals the
    eager loop on a fresh cache."""
    eng = _engine(kv, params)
    a, b = _prompts(0), _prompts(1)
    first = eng.generate(a, 8, temperature=temperature, seed=3)
    cache = eng._caches[B]
    eng.generate(b, 8, temperature=temperature, seed=4)
    assert eng._caches[B] is cache
    eng.generate(_prompts(2, b=2), 5)
    again = eng.generate(a, 8, temperature=temperature, seed=3)
    assert list(eng._caches) == [B] and eng._caches[B] is not cache
    np.testing.assert_array_equal(again.tokens, first.tokens)
    eager = eng.generate(a, 8, temperature=temperature, seed=3, scan=False)
    np.testing.assert_array_equal(eager.tokens, first.tokens)
    assert list(eng._graphs) == [(B, None)] and eng._graphs[(B, None)].cache is eng._caches[B]


@pytest.mark.parametrize("widths", [(1, 2, 3, 2, 1), (4, 4, 1, 4)])
def test_generate_keeps_the_state_of_one_width(params, widths):
    """An engine that ``generate``s at several widths, under both impl modes,
    holds one cache and the graphs of one width, the last; each run's tokens
    equal a fresh engine's."""
    qp = quantize_params(params, QuantPolicy(q=3, g=64, iters=2), device="cpu")
    eng = _engine("int8", qp)
    for i, w in enumerate(widths):
        prompts = _prompts(i, b=w)
        with impl_mode("lutgemm" if i % 2 else None):
            got = eng.generate(prompts, 4)
            fresh = _engine("int8", qp).generate(prompts, 4)
        np.testing.assert_array_equal(got.tokens, fresh.tokens)
        assert list(eng._caches) == [w]
        assert {key[0] for key in eng._graphs} == {w}
        assert all(g.cache is eng._caches[w] for g in eng._graphs.values())


def test_graphs_are_kept_per_impl_mode_and_refuse_another(params):
    """A bcq engine keeps one generate graph per (width, impl mode), and a
    graph called under another impl mode raises."""
    qp = quantize_params(params, QuantPolicy(q=3, g=64, iters=2), device="cpu")
    eng = _engine("bfloat16", qp)
    plain = eng.generate(_prompts(), 4)
    with impl_mode("lutgemm"):
        lut = eng.generate(_prompts(), 4)
    assert list(eng._graphs) == [(B, None), (B, "lutgemm")]
    np.testing.assert_array_equal(lut.tokens, plain.tokens)
    graph = eng._graphs[(B, None)]
    with impl_mode("lutgemm"), pytest.raises(RuntimeError, match="impl_mode"):
        graph(torch.zeros(B, dtype=torch.long), P)


@pytest.mark.parametrize("kv", KV)
def test_slot_graph_equals_the_eager_slot_loop(params, kv, monkeypatch):
    """Nine requests (temperatures 0, 1.0, 0.7) through 3 slots: the slot
    graph and the eager slot loop emit the same tokens; a new ``init_slots``
    makes a new graph."""
    def run():
        eng = _engine(kv, params)
        rng = np.random.default_rng(7)
        reqs = [Request(prompt=rng.integers(0, 256, size=int(rng.integers(3, 12))).astype(np.int32),
                        max_new_tokens=int(rng.integers(2, 9)), temperature=[0.0, 1.0, 0.7][i % 3], seed=i)
                for i in range(9)]
        sched = Scheduler(eng, n_slots=3, chunk=4)
        for r in reqs:
            sched.submit(r)
        return {c.rid: c.new_tokens.tolist() for c in sched.run()}, sched

    graphed, sched = run()
    graph = sched.slots["graphs"][None]
    assert graph.uses(sched.slots["cache"])
    assert not graph.uses(sched.engine.init_slots(3)["cache"])
    monkeypatch.setattr(engine_mod, "_EAGER_SLOT_STEPS", True)
    eager, sched = run()
    assert "graphs" not in sched.slots
    assert graphed == eager


def test_launch_census_counts_captures_times_replays():
    """What a capture counted is taken back (the capture launches nothing)
    and added once a replay: N replays count N × the capture's launches."""
    reset_launch_counts()
    ref0 = qmatmul.ref_calls

    def fake_capture():  # the Python side of a captured forward: wrappers count
        bcq_mm.launches += 57
        lutgemm.launches += 3
        qmatmul.ref_calls += 2
        return "logits"

    out, delta = counted(fake_capture)
    assert out == "logits"
    assert launch_counts()["bcq_mm"] == 0 and qmatmul.ref_calls == ref0
    for _ in range(4):
        add_counters(delta)
    add_counters(delta, times=3)
    assert launch_counts()["bcq_mm"] == 7 * 57 and launch_counts()["lutgemm"] == 7 * 3
    assert qmatmul.ref_calls == ref0 + 7 * 2
    before = counters()

    def failing():
        bcq_mm.launches += 5
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        counted(failing)
    assert counters() == before
    reset_launch_counts()


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


@pytest.mark.parametrize("site", ["cache_write", "chunk_decode", "forward_positions", "decode_attention",
                                  "prefill_start"])
def test_scalar_positions_raise_under_capture(params, site, monkeypatch):
    """Every path that reads a scalar position on the host raises while a
    stream is reported capturing; the ``(B,)`` path of the same step runs."""
    cfg = _cfg("int8")
    cache = init_cache(cfg, B, 16, device="cpu")
    layer = {k: v[0] for k, v in cache["stages"][0]["b0"].items()}
    p = {k: v[0] for k, v in params["stages"][0]["b0"]["attn"].items()}
    x = torch.randn(B, 1, cfg.d_model)
    kv = torch.randn(B, 1, cfg.n_kv_heads, cfg.d_head)
    tok = torch.zeros((B, 1), dtype=torch.long)
    calls = {
        "cache_write": lambda: L._cache_write(layer, kv, kv, 3),
        "chunk_decode": lambda: L._chunk_decode(torch.randn(B, 2, cfg.n_heads, cfg.d_head), layer, 3),
        "forward_positions": lambda: forward(cfg, params, tokens=tok, cache=cache, pos=3),
        "decode_attention": lambda: L.attention(p, cfg, x, torch.full((B, 1), 3), cache=layer, pos=3),
        "prefill_start": lambda: L.attention(p, cfg, torch.randn(B, 2, cfg.d_model), torch.full((B, 2), 3),
                                             cache=layer, pos=3),
    }
    _capturing(monkeypatch)
    with torch.no_grad(), pytest.raises(RuntimeError, match="scalar position"):
        calls[site]()
    with torch.no_grad():
        logits, _ = forward(cfg, params, tokens=tok, cache=cache, pos=torch.full((B,), 3))
    assert logits.shape == (B, 1, cfg.vocab)


def test_frozen_workspace_cannot_grow():
    """A graph's workspace serves any call it was sized for, and raises on
    growth once frozen (captured); the shared workspace still grows."""
    dev = torch.device("cpu")
    ws = _common.Workspace()
    with _common.use_workspace(ws):
        scratch, tickets = _common._workspace(dev, 100, 8)
    ws.freeze()
    with _common.use_workspace(ws):
        s2, t2 = _common._workspace(dev, 60, 8)
        assert s2 is scratch and t2 is tickets
        for need in ((101, 8), (100, 9)):
            with pytest.raises(RuntimeError, match="cannot grow"):
                _common._workspace(dev, *need)
    assert ws.nbytes() == 100 * 4 + 8 * 4
    shared, _ = _common._workspace(dev, 1, 1)
    grown, _ = _common._workspace(dev, shared.numel() + 1000, 1)
    assert grown.numel() >= shared.numel() + 1000 and grown is not scratch
