"""The port's observability layer (``repro_torch.obs``, the scheduler's,
engine's and prefix cache's hooks), the mirror of ``tests/test_obs.py``:

1. **Faithful**: a disturbed fault-injected serve run exports a valid
   Chrome/Perfetto trace from which every request's lifecycle is
   reconstructable, and the Prometheus export accounts for every submitted
   request (``counters_agree``); the kernels' launch census rides along as
   ``kernel_launches_total`` and its kin.
2. **Invisible**: instrumented serving gives the tokens of uninstrumented
   serving bit for bit, the same StepClock-driven deadline outcomes, and
   no graph capture and no decode graph of its own.
3. **Cheap and host-only**: the per-span cost stays under budget, and
   ``repro_torch.obs`` imports nothing but the standard library.

Port counterparts of the reference's JAX-only cases: no new compile-cache
entries (``:494``) becomes no new ``DecodeGraph`` and no scope inside a
captured step; the imports check (``:515``) loads neither torch, jax nor
the reference package; the two ``lint/obs-host-only`` cases (``:531``,
``:552``) become an AST check of module-level imports. Added: the same
calls give byte-equal ``prometheus_text`` and equal ``to_chrome`` from both
packages, and the port's instrumented scheduler gives the JAX package's
tokens, counters and per-request lifecycle sequences on the same weights.
"""

import ast
import asyncio
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.infer import PrefixCache as JPrefixCache
from repro.infer import Request as JRequest
from repro.infer import Scheduler as JScheduler
from repro.infer import StepClock as JStepClock
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, PrefixCache, Request, RequestState, Scheduler, SpecConfig, StepClock
from repro_torch.infer.graphs import DecodeGraph
from repro_torch.infer.lifecycle import RequestLifecycle, latency_summary
from repro_torch.kernels import census_families, launch_counts, qmatmul
from repro_torch.models import params_from_numpy, reduced
from repro_torch.obs import (
    Histogram,
    MetricsRegistry,
    Tracer,
    default_registry,
    parse_prometheus,
    prometheus_text,
    validate_chrome_trace,
)
from repro_torch.obs.metrics import counters_agree, exponential_buckets
from repro_torch.obs.trace import demo_serve, request_lifecycles
from repro_torch.quant import QuantPolicy, quantize_params
from torch_helpers import jax_tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 64
SIZES = dict(d_model=128, n_kv_heads=4, d_ff=256)  # the reference test's _cfg


def _cfg():
    return reduced(get_config("llama3.2-3b"), **SIZES)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """(JAX config, JAX params, the port's params): the same f32 weights."""
    jcfg = jreduced(jget_config("llama3.2-3b"), **SIZES)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _engine() -> Engine:
    return Engine(_cfg(), _jax_params()[2], max_seq=MAX_SEQ, device="cpu")


def _requests(n=4, gen=6, cls=Request):
    """Fresh Request objects every call (rids are assigned at submit and are
    single-use per scheduler)."""
    corpus = MarkovCorpus(_cfg().vocab, seed=3)
    out = []
    for i in range(n):
        plen = 4 + (i % 3)
        prompt = corpus.sample(1, plen, seed=50 + i)[0, :plen].astype(np.int32)
        out.append(cls(prompt=prompt, max_new_tokens=gen, temperature=[0.0, 0.8][i % 2], seed=20 + i))
    return out


# ---------------------------------------------------------------------------
# tracer unit behaviour
# ---------------------------------------------------------------------------


def test_span_nesting_and_ordering_under_stepclock():
    """Nested spans under a deterministic clock: exact enter/exit stamps,
    completion-ordered ring, annotations and instants land on the span."""
    clk = StepClock(dt=1.0)
    tr = Tracer(capacity=64, clock=clk)
    with tr.span("outer", lane="L", a=1) as outer:
        with tr.span("inner", lane="L"):
            pass  # enter reads t=1, exit reads t=2
        tr.instant("mark", lane="L")  # t=3
        outer.annotate(b=2)
    evs = tr.events()
    assert [(e[0], e[1]) for e in evs] == [("X", "inner"), ("i", "mark"), ("X", "outer")]
    inner, mark, outer_ev = evs
    assert (inner[4], inner[5]) == (1.0, 1.0)
    assert mark[4] == 3.0
    assert (outer_ev[4], outer_ev[5]) == (0.0, 4.0)
    assert outer_ev[6] == {"a": 1, "b": 2}


def test_span_records_exception_and_reraises():
    tr = Tracer(clock=StepClock(dt=1.0))
    with pytest.raises(RuntimeError, match="boom"):
        with tr.span("failing", lane="L"):
            raise RuntimeError("boom")
    (ev,) = tr.events()
    assert ev[1] == "failing"
    assert ev[6]["error"] == "RuntimeError: boom"


def test_ring_eviction_bounds_memory():
    tr = Tracer(capacity=4, clock=StepClock(dt=1.0))
    for i in range(10):
        tr.instant(f"i{i}", lane="L")
    assert tr.stats() == {"recorded": 10, "buffered": 4, "evicted": 6, "capacity": 4}
    assert [e[1] for e in tr.events()] == ["i6", "i7", "i8", "i9"]
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_disabled_tracer_never_reads_its_clock():
    reads = []

    def clock():
        reads.append(1)
        return 0.0

    tr = Tracer(clock=clock, enabled=False)
    with tr.span("x", lane="L") as sp:
        sp.annotate(a=1)
    tr.instant("y")
    tr.complete("z", 0.0, 1.0)
    assert reads == []
    assert tr.stats()["recorded"] == 0
    assert tr.span("a") is tr.span("b")  # the shared null handle


def test_chrome_export_schema_valid_and_lanes_labelled():
    tr = Tracer(clock=StepClock(dt=0.5))
    with tr.span("decode_chunk", cat="scheduler", lane="scheduler", ordinal=0):
        pass
    tr.complete("queued", 0.25, 0.75, cat="lifecycle", lane="req:0")
    tr.instant("finished", lane="req:0", args={"rid": 0})
    trace = tr.to_chrome()
    assert validate_chrome_trace(trace) == []
    assert validate_chrome_trace(json.dumps(trace)) == []
    events = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    assert min(e["ts"] for e in events) == 0.0
    names = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {"scheduler", "req:0"}
    assert trace["otherData"]["recorded"] == 3
    assert Tracer().chrome_events() == []


def test_validate_chrome_trace_rejects_garbage():
    assert validate_chrome_trace("not json{") != []
    assert validate_chrome_trace([1, 2]) != []
    assert validate_chrome_trace({}) == ["missing or non-list 'traceEvents'"]
    bad = {"traceEvents": [
        {"ph": "Q", "name": "x", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "X", "name": "", "pid": 1, "tid": 1, "ts": 0, "dur": 1},
        {"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": -1, "dur": -2},
        {"ph": "i", "name": "x", "pid": "1", "tid": 1, "ts": 0, "s": "q"},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1},
    ]}
    problems = validate_chrome_trace(bad)
    assert len(problems) >= 6
    assert any("ph='Q'" in p for p in problems)


def test_request_lifecycles_groups_and_sorts_by_lane():
    tr = Tracer(clock=StepClock(dt=1.0))
    tr.complete("decoding", 5.0, 9.0, lane="req:1")
    tr.complete("queued", 0.0, 5.0, lane="req:1")
    tr.complete("queued", 1.0, 2.0, lane="req:2")
    tr.instant("mark", lane="scheduler")
    lanes = request_lifecycles(tr.to_chrome())
    assert set(lanes) == {"req:1", "req:2"}
    assert [e["name"] for e in lanes["req:1"]] == ["queued", "decoding"]


# ---------------------------------------------------------------------------
# metrics registry unit behaviour
# ---------------------------------------------------------------------------


def test_counter_and_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "help text")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError, match=">= 0"):
        c.inc(-1)
    g = reg.gauge("queue_depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value == 3.0


def test_histogram_bucketing_quantiles_and_nonfinite():
    h = Histogram(bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    assert h.cumulative() == [(1.0, 1), (2.0, 2), (4.0, 3), (math.inf, 4)]
    assert h.count == 4 and h.sum == pytest.approx(105.0)
    assert h.quantile(0.5) == 2.0
    assert h.quantile(1.0) == math.inf
    h.observe(float("nan"))
    assert h.nonfinite == 1 and h.count == 4
    assert Histogram().quantile(0.5) is None
    with pytest.raises(ValueError):
        Histogram(bounds=(2.0, 1.0))
    with pytest.raises(ValueError):
        exponential_buckets(start=0.0)
    assert exponential_buckets(start=1.0, factor=2.0, count=3) == (1.0, 2.0, 4.0)


def test_registry_identity_and_morph_guards():
    reg = MetricsRegistry()
    a = reg.counter("hits_total", fmt="bcq")
    assert reg.counter("hits_total", fmt="bcq") is a
    assert reg.counter("hits_total", fmt="uniform") is not a
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("hits_total")
    with pytest.raises(ValueError, match="one name, one label set"):
        reg.counter("hits_total", impl="ref")
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad name")
    with pytest.raises(ValueError, match="invalid label name"):
        reg.counter("ok_total", **{"bad-label": "x"})


def test_registry_thread_safety_exact_totals():
    reg = MetricsRegistry()
    n_threads, per_thread = 8, 500

    def work():
        for _ in range(per_thread):
            reg.counter("hits_total").inc()
            reg.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.counter("hits_total").value == n_threads * per_thread
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    assert h.count == n_threads * per_thread
    assert h.cumulative()[0] == (0.1, n_threads * per_thread)


def test_prometheus_text_round_trips_through_parser():
    reg = MetricsRegistry()
    reg.counter("dispatch_total", "dispatches", fmt="bcq", impl="lutgemm").inc(7)
    reg.gauge("depth", "queue depth").set(3)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    text = prometheus_text(reg)
    assert "# TYPE dispatch_total counter" in text
    assert "# HELP lat_seconds latency" in text
    samples = parse_prometheus(text)
    assert samples["dispatch_total"] == [({"fmt": "bcq", "impl": "lutgemm"}, 7.0)]
    assert samples["depth"] == [({}, 3.0)]
    assert {ls["le"]: v for ls, v in samples["lat_seconds_bucket"]} == {"0.1": 1.0, "1": 1.0, "+Inf": 2.0}
    assert samples["lat_seconds_count"] == [({}, 2.0)]
    assert samples["lat_seconds_sum"][0][1] == pytest.approx(5.05)
    other = MetricsRegistry()
    other.counter("dispatch_total").inc()
    with pytest.raises(ValueError, match="more than one registry"):
        prometheus_text(reg, other)


def test_parse_prometheus_is_strict():
    assert parse_prometheus("x_total 1\nx_total{a=\"b\"} +Inf\n") == {"x_total": [({}, 1.0), ({"a": "b"}, math.inf)]}
    for bad in ("no value here and no digits", "name{unclosed=\"x\" 1", "x_total notanumber", "# BOGUS comment kind"):
        with pytest.raises(ValueError):
            parse_prometheus(bad)


def test_collector_families_export_and_refuse_duplicates():
    """The port's collectors: families read at each export, in the snapshot
    and the Prometheus text, replaced by key, refused when they duplicate a
    registered metric."""
    reg = MetricsRegistry()
    value = {"n": 1}
    reg.add_collector("k", lambda: [("census_total", "counter", "census", [({"kernel": "a"}, value["n"])])])
    value["n"] = 5  # read at export, not at registration
    assert parse_prometheus(prometheus_text(reg))["census_total"] == [({"kernel": "a"}, 5.0)]
    assert reg.snapshot()["census_total"]["series"] == [{"labels": {"kernel": "a"}, "value": 5.0}]
    reg.add_collector("k", lambda: [])  # same key: replaced
    assert "census_total" not in reg.snapshot()
    reg.counter("serve_x_total")
    reg.add_collector("dup", lambda: [("serve_x_total", "counter", "", [({}, 1)])])
    with pytest.raises(ValueError, match="duplicates"):
        reg.snapshot()
    with pytest.raises(ValueError, match="more than one registry"):
        prometheus_text(reg)


# ---------------------------------------------------------------------------
# latency_summary percentile edge cases
# ---------------------------------------------------------------------------


def test_latency_summary_empty_has_explicit_nulls():
    m = latency_summary([])
    assert m["requests"] == 0 and m["finished"] == 0
    for block in (m["ttft_s"], m["tpot_s"]):
        assert block["p50"] is None and block["p99"] is None
        assert block["mean"] is None and block["n"] == 0
    json.dumps(m)


def test_latency_summary_single_token_and_no_first_token():
    fin = RequestLifecycle(rid=0, submitted_at=0.0)
    fin.transition(RequestState.PREFILLING, 1.0)
    fin.transition(RequestState.DECODING, 2.0)
    fin.first_token_at = 3.0
    fin.n_tokens = 1
    fin.transition(RequestState.FINISHED, 4.0)
    dead = RequestLifecycle(rid=1, submitted_at=0.0)
    dead.transition(RequestState.CANCELLED, 1.0)
    m = latency_summary([fin, dead])
    assert m["requests"] == 2 and m["finished"] == 1
    assert m["no_first_token"] == 1
    assert m["ttft_s"]["n"] == 1 and m["ttft_s"]["p50"] == pytest.approx(3.0)
    assert m["ttft_s"]["excluded"] == 0
    assert m["tpot_s"]["n"] == 0 and m["tpot_s"]["excluded"] == 1
    assert m["tpot_s"]["p50"] is None
    json.dumps(m)


# ---------------------------------------------------------------------------
# scheduler integration: faithful under faults, invisible to tokens
# ---------------------------------------------------------------------------


def test_disturbed_serve_trace_reconstructs_and_metrics_account():
    """The acceptance run (``demo_serve`` on the CPU): a fault-injected
    serve (client cancel + NaN quarantine + deadline shed) exports a valid
    Chrome trace that reconstructs every request's lifecycle and a scrape in
    which every submitted request is accounted for, agreeing exactly with
    the scheduler's counters; the launch census rides along on the global
    registry (on the CPU: no kernel launches, every product on the oracle)."""
    ref0 = qmatmul.ref_calls
    sched, tracer, registry = demo_serve(device="cpu")
    assert tracer.stats()["evicted"] == 0
    trace = tracer.to_chrome()
    assert validate_chrome_trace(trace) == []
    lanes = request_lifecycles(json.dumps(trace))
    for rid, rec in sched.outcomes.items():
        lane = lanes.get(f"req:{rid}")
        assert lane is not None, f"request {rid} missing from the trace"
        names = [e["name"] for e in lane]
        assert names[0] == "submit"
        assert names[-1] == rec.state.value
        if rec.state is RequestState.FINISHED:
            assert {"queued", "prefilling", "decoding"} <= set(names)
        ts = [e["ts"] for e in lane]
        assert ts == sorted(ts)
    assert {"finished", "failed", "cancelled", "shed"} <= {r.state.value for r in sched.outcomes.values()}
    event_names = [e[1] for e in tracer.events()]
    assert "nan_quarantine" in event_names and "decode_chunk" in event_names
    assert {"engine/prefill", "engine/admit", "engine/scan_decode"} <= set(event_names)

    samples = parse_prometheus(prometheus_text(registry))
    submitted = sum(v for _, v in samples["serve_submitted_total"])
    terminal = sum(sum(v for _, v in samples.get(f"serve_{k}_total", []))
                   for k in ("finished", "cancelled", "timed_out", "shed", "failed", "rejected_queue_full"))
    assert submitted == len(sched.outcomes) and submitted == terminal
    assert counters_agree(registry, sched.counters) == []

    default_registry().add_collector("kernel_census", census_families)
    glob = parse_prometheus(prometheus_text(default_registry()))
    assert {ls["kernel"]: v for ls, v in glob["kernel_launches_total"]} == launch_counts()
    assert glob["qmatmul_ref_calls_total"] == [({}, float(qmatmul.ref_calls))]
    assert qmatmul.ref_calls > ref0


def test_instrumented_serving_token_identical():
    eng = _engine()
    plain_sched = Scheduler(eng, n_slots=2, chunk=3)
    for r in _requests():
        plain_sched.submit(r)
    plain = {c.rid: c.new_tokens for c in plain_sched.run()}

    tr, reg = Tracer(), MetricsRegistry()
    sched = Scheduler(eng, n_slots=2, chunk=3, tracer=tr, metrics=reg)
    for r in _requests():
        sched.submit(r)
    instrumented = {c.rid: c.new_tokens for c in sched.run()}
    assert set(plain) == set(instrumented)
    for rid in plain:
        np.testing.assert_array_equal(plain[rid], instrumented[rid])
    assert tr.stats()["recorded"] > 0
    assert counters_agree(reg, sched.counters) == []
    assert reg.counter("serve_tokens_total").value == sum(len(t) for t in plain.values())
    assert reg.gauge("serve_queue_depth").value == 0
    assert reg.histogram("serve_ttft_seconds").count == len(plain)


def test_tracing_does_not_perturb_stepclock_deadlines():
    """The tracer has its own clock: recording spans never takes scheduler
    clock readings, so a StepClock-driven run's deadline outcome is the
    same with and without instrumentation."""
    eng = _engine()

    def run(instrumented):
        clk = StepClock(dt=0.05)
        kw = dict(clock=clk, sleep=clk.sleep)
        if instrumented:
            kw.update(tracer=Tracer(), metrics=MetricsRegistry())
        sched = Scheduler(eng, n_slots=1, chunk=2, **kw)
        reqs = _requests(n=3, gen=4)
        reqs[-1].deadline_s = 0.01
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched.summary()["by_state"], dict(sched.counters)

    assert run(False) == run(True)


def test_speculative_spans_account_for_draft_verify_rollback():
    cfg = _cfg()
    params = quantize_params(_jax_params()[2], QuantPolicy(q=3, g=32, iters=2), device="cpu")
    tr, reg = Tracer(), MetricsRegistry()
    eng = Engine(cfg, params, max_seq=MAX_SEQ, tracer=tr, device="cpu")
    spec = SpecConfig(q_draft=2, gamma=2)
    sched = Scheduler(eng, n_slots=2, chunk=2, speculate=spec, tracer=tr, metrics=reg)
    corpus = MarkovCorpus(cfg.vocab, seed=3)
    for i in range(2):
        prompt = corpus.sample(1, 5, seed=300 + i)[0, :5].astype(np.int32)
        sched.submit(Request(prompt=prompt, max_new_tokens=6))
    assert len(sched.run()) == 2
    verifies = [e for e in tr.events() if e[1] == "spec_verify"]
    assert verifies, "speculative run emitted no spec_verify annotations"
    committed_in_chunks = 0
    for ev in verifies:
        args = ev[6]
        assert args["drafted"] == spec.gamma
        assert 0 <= args["accepted"] <= spec.gamma
        assert args["accepted"] + args["rolled_back"] == spec.gamma
        assert ev[3].startswith("req:")
        committed_in_chunks += args["accepted"] + 1
    assert committed_in_chunks == sched.steps_active
    assert reg.gauge("serve_spec_accept_rate").value == pytest.approx(sched.spec_accept_rate)
    names = {e[1] for e in tr.events()}
    assert {"engine/spec_chunks", "engine/prefill_draft"} <= names


# ---------------------------------------------------------------------------
# the hooks stay outside captured graphs; the package is host-only
# ---------------------------------------------------------------------------


def test_instrumentation_adds_no_graph_capture(monkeypatch):
    """The port's counterpart of the reference's no-new-compile-cache-entries
    check: an engine with a tracer makes exactly the decode graphs an
    engine without one makes (one per width and impl mode, reused across
    calls), enters no scope inside the graph's step (the function a capture
    records), and emits the uninstrumented engine's tokens bit for bit."""
    made, in_step, entered = [], [], []
    real_init, real_step, real_scope = DecodeGraph.__init__, DecodeGraph.step, Engine._obs_scope

    def init(self, *a, **kw):
        made.append(self)
        real_init(self, *a, **kw)

    def step(self):
        in_step.append(True)
        try:
            return real_step(self)
        finally:
            in_step.pop()

    def scope(self, name, **args):
        entered.append((name, bool(in_step)))
        return real_scope(self, name, **args)

    monkeypatch.setattr(DecodeGraph, "__init__", init)
    monkeypatch.setattr(DecodeGraph, "step", step)
    monkeypatch.setattr(Engine, "_obs_scope", scope)
    corpus = MarkovCorpus(_cfg().vocab, seed=3)
    p = corpus.sample(1, 5, seed=400)[0, :5].astype(np.int32)
    runs = {}
    for name, tracer in (("plain", None), ("traced", Tracer())):
        eng = Engine(_cfg(), _jax_params()[2], max_seq=MAX_SEQ, tracer=tracer, device="cpu")
        made.clear()
        out = eng.generate(p[None], 6)
        eng.generate(corpus.sample(1, 5, seed=401)[0, :5].astype(np.int32)[None], 6)
        sched = Scheduler(eng, n_slots=2, chunk=3)
        for r in _requests(n=3):
            sched.submit(r)
        sched.run()
        runs[name] = (out.tokens, len(made), tracer)
    assert runs["plain"][1] == runs["traced"][1] == 2  # generate's graph and the slot batch's
    assert entered and not any(inside for _, inside in entered)
    names = {e[1] for e in runs["traced"][2].events()}
    assert {"engine/prefill", "engine/scan_decode", "engine/admit"} <= names
    np.testing.assert_array_equal(runs["plain"][0], runs["traced"][0])


def test_obs_package_imports_without_torch_or_jax():
    """``repro_torch.obs`` is host-side only: importing it loads neither
    torch, jax nor the reference package (a subprocess, so this module's
    own imports cannot mask a regression)."""
    code = (
        "import sys; import repro_torch.obs; import repro_torch.obs.trace; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')); "
        "assert not bad, f'repro_torch.obs pulled {bad[:3]}'"
    )
    subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                   check=True, timeout=120)


def _module_level_imports(source: str):
    """(line, module) of every import that runs when the module is imported:
    at top level or inside a top-level ``try`` / ``if`` / ``with``, not inside
    a function or class body."""
    out = []

    def visit(nodes):
        for node in nodes:
            if isinstance(node, ast.Import):
                out.extend((node.lineno, a.name) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                out.append((node.lineno, "." * node.level + (node.module or "")))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            else:
                for field in ("body", "orelse", "finalbody", "handlers"):
                    visit(getattr(node, field, []))

    visit(ast.parse(source).body)
    return out


def _not_host_only(source: str):
    """Lines whose module-level import is neither the standard library nor
    ``repro_torch.obs`` itself."""
    return [line for line, mod in _module_level_imports(source)
            if not (mod.split(".")[0] in sys.stdlib_module_names or mod == "__future__"
                    or mod == "repro_torch.obs" or mod.startswith("repro_torch.obs."))]


def test_obs_host_only_import_check():
    bad = (
        "import torch\n"
        "from repro_torch.kernels import ops\n"
        "try:\n"
        "    import repro_torch.models\n"
        "except ImportError:\n"
        "    pass\n"
        "def demo():\n"
        "    import torch  # lazy: allowed\n"
    )
    assert _not_host_only(bad) == [1, 2, 4]
    assert _not_host_only("import json\ndef demo():\n    from repro_torch.infer import Engine\n") == []
    assert _not_host_only("from repro_torch.obs.metrics import Counter\nimport jax\n") == [2]


def test_repo_obs_modules_host_only():
    """Every module of ``repro_torch/obs`` imports only the standard library
    (and its own package) at module level; the engine and the kernels come
    in lazily, inside ``demo_serve`` and ``main``."""
    files = sorted((ROOT / "src" / "repro_torch" / "obs").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "metrics.py", "trace.py"}
    for path in files:
        assert _not_host_only(path.read_text()) == [], path


def test_tracer_overhead_within_budget():
    """A recorded span costs two clock readings and a deque append; held to
    a 50x slack bound so a loaded host never flakes."""
    tr = Tracer(capacity=100_000)
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        with tr.span("bench", lane="bench", i=i):
            pass
    per_span = (time.perf_counter() - t0) / n
    assert tr.stats()["recorded"] == n
    assert per_span < 100e-6, f"{per_span * 1e6:.1f} µs/span exceeds budget"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _drive_obs(reg, tracer):
    """The same metric, span and instant calls on either package's objects."""
    reg.counter("dispatch_total", "dispatches", fmt="bcq", impl="lutgemm").inc(7)
    reg.counter("dispatch_total", "dispatches", fmt="uniform", impl="ref").inc(2.5)
    reg.gauge("depth", "queue depth").set(3)
    reg.gauge("ratio", "a fraction").set(0.1 + 0.2)
    h = reg.histogram("lat_seconds", "latency")
    for v in (1e-5, 0.003, 0.25, 7.0, 1e4, float("nan")):
        h.observe(v)
    reg.histogram("toks", "tokens", buckets=(1.0, 2.0, 4.0), slot="a\"b\\c").observe(3)
    with tracer.span("decode_chunk", cat="scheduler", lane="scheduler", ordinal=0) as sp:
        tracer.instant("retry", cat="fault", lane="scheduler", args={"attempt": 1})
        sp.annotate(tokens=5)
    tracer.complete("queued", 0.25, 0.75, cat="lifecycle", lane="req:0", args={"rid": 0})
    tracer.instant("finished", ts=1.5, lane="req:0", args={"rid": 0, "reason": "budget exhausted"})
    with pytest.raises(RuntimeError):
        with tracer.span("engine/prefill", cat="engine", lane="engine"):
            raise RuntimeError("boom")


def test_obs_exports_equal_the_reference_packages():
    """The same calls give byte-equal Prometheus text, equal snapshots and
    equal Chrome traces from ``repro_torch.obs`` and ``repro.obs``."""
    ours, theirs = MetricsRegistry(), jmetrics.MetricsRegistry()
    tr_ours, tr_theirs = Tracer(clock=StepClock(dt=0.125)), jtrace.Tracer(clock=JStepClock(dt=0.125))
    _drive_obs(ours, tr_ours)
    _drive_obs(theirs, tr_theirs)
    assert prometheus_text(ours) == jmetrics.prometheus_text(theirs)
    assert json.dumps(ours.snapshot(), sort_keys=True) == json.dumps(theirs.snapshot(), sort_keys=True)
    assert tr_ours.to_chrome() == tr_theirs.to_chrome()
    assert validate_chrome_trace(tr_ours.to_chrome()) == jtrace.validate_chrome_trace(tr_theirs.to_chrome()) == []
    assert request_lifecycles(tr_ours.to_chrome()) == jtrace.request_lifecycles(tr_theirs.to_chrome())
    assert counters_agree(ours, {"x": 1}, prefix="dispatch_") == jmetrics.counters_agree(theirs, {"x": 1},
                                                                                      prefix="dispatch_")


def _shared_prefix_requests(n, cls, *, prefix_len=12, gen=5):
    """Greedy requests sharing a system prompt (tails of 2..5 tokens)."""
    corpus = MarkovCorpus(_cfg().vocab, seed=3)
    shared = corpus.sample(1, prefix_len, seed=99)[0, :prefix_len]
    out = []
    for i in range(n):
        tlen = 2 + (i % 4)
        tail = corpus.sample(1, tlen, seed=100 + i)[0, :tlen]
        out.append(cls(prompt=np.concatenate([shared, tail]).astype(np.int32), max_new_tokens=gen))
    return out


def test_instrumented_scheduler_matches_jax_package():
    """The port's instrumented scheduler and the JAX package's, on the same
    f32 weights with a prefix cache and chunked prefill, the same greedy
    requests in two waves under a StepClock each: equal tokens, equal
    ``serve_*_total`` and ``prefix_*_total`` counters and, per request, the
    same sequence of lifecycle events (names and order)."""
    jcfg, jp, tp = _jax_params()
    jeng = JEngine(jcfg, jp, max_seq=MAX_SEQ, prefix_cache=JPrefixCache(block_tokens=4))
    teng = Engine(_cfg(), tp, max_seq=MAX_SEQ, device="cpu", prefix_cache=PrefixCache(block_tokens=4))
    out = {}
    for name, eng, sched_cls, req_cls, clock_cls, reg_cls, tr_cls in (
            ("jax", jeng, JScheduler, JRequest, JStepClock, jmetrics.MetricsRegistry, jtrace.Tracer),
            ("port", teng, Scheduler, Request, StepClock, MetricsRegistry, Tracer)):
        reg, tokens, lanes = reg_cls(), [], []
        for wave in range(2):  # the first wave misses and commits, the second hits
            clk, tracer = clock_cls(dt=0.01), tr_cls()
            sched = sched_cls(eng, n_slots=2, chunk=3, prefill_chunk=4, clock=clk, sleep=clk.sleep,
                              tracer=tracer, metrics=reg)
            reqs = _shared_prefix_requests(5, req_cls)
            rids = [sched.submit(r) for r in reqs]
            done = {c.rid: c for c in sched.run()}
            tokens += [np.asarray(done[rid].new_tokens) for rid in rids]
            lanes.append({lane: [e["name"] for e in evs]
                          for lane, evs in request_lifecycles(tracer.to_chrome()).items()})
        snap = reg.snapshot()
        counters = {k: sum(s["value"] for s in fam["series"]) for k, fam in snap.items()
                    if fam["type"] == "counter" and k.startswith(("serve_", "prefix_"))}
        out[name] = (tokens, counters, lanes)
    (jt, jc, jl), (tt, tc, tl) = out["jax"], out["port"]
    assert len(jt) == len(tt) == 10
    for i, (a, b) in enumerate(zip(jt, tt)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert tc == jc
    assert tc["prefix_hits_total"] >= 5 and tc["serve_finished_total"] == 10
    assert tl == jl and [len(w) for w in tl] == [5, 5]
    assert tl[0]["req:0"][0] == "submit" and tl[0]["req:0"][-1] == "finished"


def test_pareto_arrivals_match_reference():
    from repro.launch.serve import pareto_arrivals as jpareto
    from repro_torch.launch.serve import pareto_arrivals

    for n, rate, alpha, seed in ((16, 8.0, 1.5, 0), (40, 2.5, 1.2, 7), (5, 0.0, 1.5, 1)):
        np.testing.assert_array_equal(pareto_arrivals(n, rate, alpha=alpha, seed=seed),
                                      jpareto(n, rate, alpha=alpha, seed=seed))
    with pytest.raises(ValueError, match="alpha"):
        pareto_arrivals(4, 1.0, alpha=1.0)


# ---------------------------------------------------------------------------
# server export surfaces
# ---------------------------------------------------------------------------


def _go(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_session_exports_prometheus_and_trace():
    from repro_torch.launch.server import ServeSession

    eng = _engine()
    (req,) = _requests(n=1, gen=5)

    async def run():
        async with ServeSession(eng, n_slots=2, chunk=3) as sess:
            stream = await sess.submit_stream(req)
            await stream.drain()
            return sess.metrics(), sess.prometheus(), sess.trace_json()

    m, text, trace = _go(run())
    assert "registry" in m and "tracer" in m
    assert m["tracer"]["recorded"] > 0
    samples = parse_prometheus(text)
    assert sum(v for _, v in samples["serve_submitted_total"]) == 1
    assert sum(v for _, v in samples["serve_finished_total"]) == 1
    assert "serve_slot_capacity" in samples
    assert {ls["kernel"]: v for ls, v in samples["kernel_launches_total"]} == launch_counts()
    assert validate_chrome_trace(trace) == []
    assert "req:0" in request_lifecycles(trace)

    from repro_torch.launch.server import ServeSession as Session

    dark = Session(eng, observe=False)
    assert dark.tracer is None and dark.registry is None
    with pytest.raises(RuntimeError, match="no metrics registry"):
        dark.prometheus()
    with pytest.raises(RuntimeError, match="no tracer"):
        dark.trace_json()


def test_http_prometheus_and_trace_endpoints():
    aiohttp = pytest.importorskip("aiohttp")
    from repro_torch.launch.server import ServeSession, bound_port, run_server

    eng = _engine()
    (req,) = _requests(n=1, gen=4)

    async def run():
        session = ServeSession(eng, n_slots=1, chunk=2)
        async with session:
            runner = await run_server(session, port=0)
            base = f"http://127.0.0.1:{bound_port(runner)}"
            try:
                stream = await session.submit_stream(req)
                await stream.drain()
                async with aiohttp.ClientSession() as client:
                    async with client.get(f"{base}/v1/metrics", params={"format": "prometheus"}) as r:
                        assert r.status == 200
                        assert r.content_type == "text/plain"
                        text = await r.text()
                    async with client.get(f"{base}/v1/metrics") as r:
                        summary = await r.json()
                    async with client.get(f"{base}/v1/trace") as r:
                        trace = await r.json()
            finally:
                await runner.cleanup()
        return text, summary, trace

    text, summary, trace = _go(run(), timeout=180.0)
    samples = parse_prometheus(text)
    assert sum(v for _, v in samples["serve_finished_total"]) == 1
    # the scrape merges the process-global registry: the launch census
    assert "kernel_launches_total" in samples and "qmatmul_ref_calls_total" in samples
    assert summary["by_state"] == {"finished": 1}
    assert "registry" in summary and "tracer" in summary
    assert validate_chrome_trace(trace) == []
    assert request_lifecycles(trace)
