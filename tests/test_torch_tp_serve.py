"""Tensor-parallel serving in the port (``Engine(mesh=...)``) against the
port at tp = 1 and the JAX package's TP engine: the differential harness of
the reference's ``test_tp_serve.py`` and its prefix-cache GRID's tp rows.

The ranks are real processes: ``launch/_ranks.py::run_ranks`` spawns 2 or 4
ranks over gloo on the host, each builds the same engine from the same
JAX-quantized weights (carried across bit for bit) and keeps its slices.
A spawn costs seconds, so every scenario of one tp runs in one spawn
(``tests/torch_tp_ranks.py``, which imports no JAX) and the tests below
read its results. The tp = 1 references run the same scenarios in this
process with ``mesh=None``.

- **greedy tokens** at tp ∈ {2, 4}, q ∈ {0, 2, 4}, fused and unfused equal
  the port's at tp = 1 and ``repro.infer.Engine(mesh=make_tp_mesh(tp))``'s:
  the row-parallel partial sums only reorder an f32 sum, which moves the
  logits by ~1e-6, not enough to flip an argmax here;
- **logits** within ``LOGIT_TOL`` = 1e-3 (rtol and atol) of tp = 1, the
  reference's tolerance (``test_tp_serve.py:135``);
- within one TP engine, bit for bit: every rank the same tokens, slot ==
  solo (greedy against tp = 1, mixed temperatures against the TP engine's
  own solo), spec == plain, warm == cold, the step loop == ``scan=True``;
- every forward issues 2L + 1 collectives, and a TP engine decodes eagerly
  (``GenerationResult.captured`` is False).
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.parallel.tp import make_tp_mesh as jmake_tp_mesh
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.infer import SpecConfig
from repro_torch.launch import serve
from repro_torch.launch._ranks import run_ranks
from torch_helpers import jax_tree_to_numpy
import torch_tp_ranks as R

pytestmark = pytest.mark.needs_multidevice

Q_GROUP = 32  # (k/g) divisible by tp = 4 for wo (k 128) and w_down (k 256)
LOGIT_TOL = 1e-3
N_LAYERS = 2
# params key → (format, q); the reference's QuantPolicy(q, g=32, iters=2, fmt)
PARAMS = {"dense": (None, 0), "bcq2": ("bcq", 2), "bcq3": ("bcq", 3), "bcq4": ("bcq", 4),
          "codebook3": ("codebook", 3), "ternary3": ("ternary", 3)}
GREEDY = [(key, fuse) for key in ("dense", "bcq2", "bcq4") for fuse in (True, False)]
SPECS = [("bcq2", 1), ("bcq4", 2)]
WARM_GRID = [("dense", None), ("bcq3", SpecConfig(q_draft=2, gamma=3)), ("ternary3", None)]
FORMATS = ("codebook3", "ternary3")


@functools.lru_cache(maxsize=None)
def _jax_params(key):
    fmt, q = PARAMS[key]
    jcfg = jreduced(jget_config("llama3.2-3b"), **R.SIZES)
    params = jinit_params(jax.random.PRNGKey(0), jcfg)
    if q:
        params = jquantize_params(params, JPolicy(q=q, g=Q_GROUP, iters=2, fmt=fmt))
    return jcfg, params


@functools.lru_cache(maxsize=None)
def _np_params():
    return {key: jax_tree_to_numpy(_jax_params(key)[1]) for key in PARAMS}


def _cases(tp):
    cases = {f"greedy/{key}/{fuse}": ("greedy", key, dict(fuse=fuse)) for key, fuse in GREEDY}
    cases["steploop/bcq4"] = ("greedy", "bcq4", dict(scan=False))
    cases.update({f"logits/{key}": ("logits", key, {}) for key in ("dense", "bcq4")})
    cases["sampled/bcq4"] = ("sampled", "bcq4", {})
    cases.update({f"slots/{key}": ("slots", key, {}) for key in ("dense", "bcq4")})
    cases["mixed/bcq4"] = ("mixed", "bcq4", {})
    cases.update({f"spec/{key}/{qd}": ("speculative", key, dict(q_draft=qd)) for key, qd in SPECS})
    if tp == 2:
        cases.update({f"greedy/{key}/True": ("greedy", key, {}) for key in FORMATS})
        cases["spec/ternary3/1"] = ("speculative", "ternary3", dict(q_draft=1))
        cases["spec_slots/bcq4"] = ("spec_slots", "bcq4", {})
        cases.update({f"warm/{key}": ("warm_cold", key, dict(spec=spec)) for key, spec in WARM_GRID})
    return cases


@functools.lru_cache(maxsize=None)
def _runs():
    """Every rank's results of every case at tp 2 and 4 (one spawn each,
    both running while this process runs the JAX TP engines) and the JAX TP
    engines' greedy tokens."""
    params = _np_params()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        spawns = {tp: pool.submit(run_ranks, R.rank_main, tp, (_cases(tp), params), device="cpu", timeout=300)
                  for tp in (2, 4)}
        jax_tokens = {(key, fuse, tp): _jax_tp_tokens(key, fuse, tp)
                      for key, fuse in GREEDY + [(k, True) for k in FORMATS] for tp in (2, 4)
                      if tp == 2 or key not in FORMATS}
        return {tp: f.result() for tp, f in spawns.items()}, jax_tokens


def _ranks(tp):
    return _runs()[0][tp]


@functools.lru_cache(maxsize=None)
def _single(name):
    """A tp = 1 scenario of the port, in this process."""
    torch.set_num_threads(1)
    fn, key, kw = name
    return R.SCENARIOS[fn](_np_params()[key], None, **dict(kw))


def _jax_tp_tokens(key, fuse, tp):
    jcfg, params = _jax_params(key)
    eng = JEngine(jcfg, params, max_seq=R.MAX_SEQ, mesh=jmake_tp_mesh(tp), fuse=fuse)
    return eng.generate(R.prompts(), R.N_STEPS).tokens


def _rank0(tp, name):
    return _ranks(tp)[0][name]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key,fuse", GREEDY, ids=[f"{k}-{'fused' if f else 'unfused'}" for k, f in GREEDY])
def test_greedy_tokens_equal_tp1_and_jax_tp(key, fuse, tp):
    got = _rank0(tp, f"greedy/{key}/{fuse}")["tokens"]
    np.testing.assert_array_equal(got, _single(("greedy", key, (("fuse", fuse),)))["tokens"])
    np.testing.assert_array_equal(got, _runs()[1][key, fuse, tp])


@pytest.mark.parametrize("key", FORMATS)
def test_new_format_tp_greedy_identical(key):
    got = _rank0(2, f"greedy/{key}/True")["tokens"]
    np.testing.assert_array_equal(got, _single(("greedy", key, ()))["tokens"])
    np.testing.assert_array_equal(got, _runs()[1][key, True, 2])


@pytest.mark.parametrize("tp", [2, 4])
def test_every_rank_returns_the_same_results(tp):
    """Logits are gathered whole and every rank runs the same host code with
    the same generators, so every rank's every result is rank 0's."""
    runs = _ranks(tp)
    for rank in range(1, tp):
        for name, value in runs[0].items():
            np.testing.assert_equal(runs[rank][name], value, err_msg=f"tp={tp} rank {rank} {name}")


@pytest.mark.parametrize("tp", [2, 4])
def test_collectives_and_eager_decode(tp):
    """2L + 1 collectives a forward (an all-reduce after every wo and
    w_down, one all-gather of the logits); the TP engine never captures."""
    run = _rank0(tp, "greedy/bcq4/True")
    assert run["collectives"] == {"all_reduce": 2 * N_LAYERS, "all_gather": 1, "broadcast": 0}
    assert run["captured"] is False


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_scan_and_steploop_agree(tp):
    np.testing.assert_array_equal(_rank0(tp, "steploop/bcq4")["tokens"], _rank0(tp, "greedy/bcq4/True")["tokens"])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key", ["dense", "bcq4"])
def test_logits_close_to_single_device(key, tp):
    got, ref = _rank0(tp, f"logits/{key}"), _single(("logits", key, ()))
    for part in ("prefill", "decode"):
        np.testing.assert_allclose(got[part], ref[part], rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_sampled_deterministic(tp):
    a, b = _rank0(tp, "sampled/bcq4")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key", ["dense", "bcq4"])
def test_slot_scheduler_tokens_identical(key, tp):
    """5 requests through 2 slots (mid-flight admissions) against solo
    generates on the single-device engine."""
    for i, (got, solo) in enumerate(zip(_rank0(tp, f"slots/{key}"), _single(("solos", key, ())))):
        np.testing.assert_array_equal(got, solo, err_msg=f"request {i}")


@pytest.mark.parametrize("tp", [2, 4])
def test_slot_scheduler_mixed_temps_match_tp_solo(tp):
    run = _rank0(tp, "mixed/bcq4")
    for i, (got, solo) in enumerate(zip(run["slots"], run["solo"])):
        np.testing.assert_array_equal(got, solo, err_msg=f"request {i}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("key,q_draft", SPECS, ids=["bcq2_d1", "bcq4_d2"])
def test_speculative_greedy_identical(key, q_draft, tp):
    run = _rank0(tp, f"spec/{key}/{q_draft}")
    np.testing.assert_array_equal(run["tokens"], _single(("greedy", key, ()))["tokens"])
    assert run["chunks"] >= 1


def test_ternary_speculative_tp_greedy_identical():
    np.testing.assert_array_equal(_rank0(2, "spec/ternary3/1")["tokens"], _single(("greedy", "ternary3", ()))["tokens"])


def test_speculative_slot_scheduler_tp():
    solos = _single(("solos", "bcq4", (("n", 4),)))
    for i, (got, solo) in enumerate(zip(_rank0(2, "spec_slots/bcq4"), solos)):
        np.testing.assert_array_equal(got, solo, err_msg=f"request {i}")


@pytest.mark.parametrize("key,spec", WARM_GRID, ids=[f"{k}-{'spec' if s else 'plain'}-tp2" for k, s in WARM_GRID])
def test_warm_vs_cold_bit_identity(key, spec):
    run = _rank0(2, f"warm/{key}")
    assert run["counters"]["hits"] > max(run["hits_before"], 0)
    for i, (warm, cold) in enumerate(zip(run["warm"], run["cold"])):
        np.testing.assert_array_equal(warm, cold, err_msg=f"request {i}: warm-cache tokens diverged ({key}, tp=2)")
    np.testing.assert_array_equal(run["warm"][0], run["solo"])
    c = run["counters"]
    assert c["hits"] + c["misses"] == c["commits"] + c["aborts"] and run["pinned"] == 0


def _sample_line(text):
    (line,) = [ln for ln in text.splitlines() if ln.startswith("sample:")]
    return line


def test_serve_cli_tp(capfd):
    """``--tp 2`` prints the sample tokens of ``--tp 1``; ``--tp 0`` is an
    argparse error and an indivisible split a ValueError naming the leaf,
    raised before any rank starts."""
    argv = ["--device", "cpu", "--g", "64", "--requests", "3", "--gen", "4", "--prompt-len", "6"]
    serve.main(argv + ["--tp", "1"])
    one = capfd.readouterr().out
    serve.main(argv + ["--tp", "2"])
    two = capfd.readouterr().out
    assert _sample_line(two) == _sample_line(one)
    assert "backend gloo" in two and "'all_gather': " in two
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--tp", "0"])
    assert "--tp must be >= 1" in capfd.readouterr().err
    with pytest.raises(ValueError, match=r"wo.*k/g dim 2 .*g \| 64"):
        serve.main(["--device", "cpu", "--tp", "4", "--g", "128"])
    with pytest.raises(ValueError, match="heads"):
        serve.main(["--device", "cpu", "--tp", "3", "--g", "64"])


@pytest.mark.parametrize("case", ["fails", "hangs"])
def test_run_ranks_kills_the_others(case):
    """A rank that fails (its traceback named) or outlives the timeout makes
    ``run_ranks`` kill every rank and raise: no hang reaches the suite."""
    import multiprocessing

    before = set(multiprocessing.active_children())
    if case == "fails":
        with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] failed:(.|\n)*rank 1 fails on purpose"):
            run_ranks(R.failing_rank, 2, device="cpu", timeout=120)
    else:
        with pytest.raises(TimeoutError, match=r"ranks \[0\] did not finish within 15s"):
            run_ranks(R.hanging_rank, 2, device="cpu", timeout=15)
    assert set(multiprocessing.active_children()) <= before
