"""Port parity and invariants for the engine, the serve CLI and the port's
import hygiene (no JAX, nothing of the ``repro`` package).

Cross-package greedy decoding is checked by teacher forcing: the JAX engine's
greedy tokens are fed to both packages and the per-step logits compared
within rtol = atol = 2e-5 (f32). Token identity is asserted only at steps
where JAX's top-1/top-2 margin exceeds that tolerance, because random-init
logits are nearly flat and a near-tie may flip on summation order alone.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.infer import Engine
from repro_torch.launch import serve
from repro_torch.models import init_params, params_from_numpy, reduced
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.utils import tree_leaves
from torch_helpers import jax_tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
SIZES = dict(d_model=256, n_kv_heads=4, d_ff=512)
B, S, N = 2, 8, 6


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("llama3.2-3b"), **SIZES)
    jq = jquantize_params(jinit_params(jax.random.PRNGKey(0), jcfg), JPolicy(q=4, g=128, method="greedy"))
    tcfg = reduced(get_config("llama3.2-3b"), **SIZES)
    tq = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    return jcfg, jq, tcfg, tq


def _prompts():
    return np.random.default_rng(3).integers(0, 256, size=(B, S)).astype(np.int32)


def test_greedy_teacher_forced_against_jax(models):
    jcfg, jq, tcfg, tq = models
    jeng = JEngine(jcfg, jq, max_seq=32)
    jtoks = jeng.generate(_prompts(), N).tokens
    jnew = jtoks[:, S:]

    # JAX per-step logits along its own greedy path
    jcache = jeng._make_cache(B)
    jl, jcache = jeng._prefill(jeng.params, jax.numpy.asarray(jtoks[:, :S]), None, jcache)
    jlogits = [np.asarray(jl[:, -1])]
    for t in range(N - 1):
        jl, jcache = jeng._decode(
            jeng.params, jax.numpy.asarray(jtoks[:, S + t : S + t + 1]), jcache, jax.numpy.int32(S + t)
        )
        jlogits.append(np.asarray(jl[:, -1]))
    jlogits = np.stack(jlogits)  # (N, B, V)
    np.testing.assert_array_equal(jlogits.argmax(-1).T, jnew)

    eng = Engine(tcfg, tq, max_seq=32, device="cpu")
    tt = torch.from_numpy(jtoks).long()
    cache = eng._make_cache(B)
    tl, cache = eng.prefill(tt[:, :S], cache)
    tlogits = [tl.numpy()]
    for t in range(N - 1):
        tl, cache = eng.decode(tt[:, S + t : S + t + 1], cache, S + t)
        tlogits.append(tl.numpy())
    tlogits = np.stack(tlogits)
    np.testing.assert_allclose(tlogits, jlogits, rtol=TOL, atol=TOL)

    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 4 * TOL * (1 + np.abs(top2[..., 1]))
    assert decisive.mean() > 0.5
    np.testing.assert_array_equal(tlogits.argmax(-1)[decisive], jlogits.argmax(-1)[decisive])
    # where every step is decisive, the port's own greedy run emits JAX's tokens
    ours = eng.generate(_prompts(), N).tokens
    for b in range(B):
        if decisive[:, b].all():
            np.testing.assert_array_equal(ours[b], jtoks[b])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_scan_and_step_loop_bit_identical(models, temperature):
    _, _, tcfg, tq = models
    eng = Engine(tcfg, tq, max_seq=32, device="cpu")
    a = eng.generate(_prompts(), N, temperature=temperature, seed=5, scan=True)
    b = eng.generate(_prompts(), N, temperature=temperature, seed=5, scan=False)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.tokens.shape == (B, S + N) and a.prompt_len == S and a.steps == N
    np.testing.assert_array_equal(a.generated(1), a.tokens[1, S:])


def test_sampling_reproducible_for_a_seed(models):
    _, _, tcfg, tq = models
    eng = Engine(tcfg, tq, max_seq=32, fuse=False, device="cpu")
    runs = [eng.generate(_prompts(), N, temperature=1.0, seed=s).tokens for s in (11, 11, 12)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < tcfg.vocab)).all()


def test_generate_validates_requests(models):
    _, _, tcfg, tq = models
    eng = Engine(tcfg, tq, max_seq=12, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(_prompts(), 5)
    bad = _prompts()
    bad[0, 0] = 256
    with pytest.raises(ValueError, match="vocab"):
        eng.generate(bad, 2)


def test_engine_device_defaults_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    _, _, tcfg, tq = models
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(tcfg, tq)


def test_serve_cli_sequential_on_cpu(capsys):
    serve.main(["--sequential", "--device", "cpu", "--requests", "2", "--gen", "3",
                "--prompt-len", "6", "--q", "2", "--g", "64"])
    out = capsys.readouterr().out
    assert "[sequential] 2 requests, 6 tokens" in out
    assert "bcq q=2 g=64" in out and "sample:" in out


@pytest.mark.parametrize("fmt", ["bcq", "uniform", "dequant", "ternary", "codebook"])
def test_serve_cli_sequential_each_format_on_cpu(capsys, fmt):
    serve.main(["--sequential", "--device", "cpu", "--requests", "2", "--gen", "3",
                "--prompt-len", "6", "--q", "2", "--g", "64", "--format", fmt])
    out = capsys.readouterr().out
    assert f"{fmt} q=2 g=64" in out and "[sequential] 2 requests, 6 tokens" in out


def test_serve_cli_continuous_is_the_default_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "5", "--gen", "4", "--prompt-len", "6",
                "--q", "2", "--g", "64", "--slots", "2", "--chunk", "3"])
    out = capsys.readouterr().out
    assert "[continuous] 5 requests, 20 tokens" in out
    assert "2 slots, chunk=3" in out and "kernel launches:" in out and "sample:" in out


@pytest.mark.parametrize("fmt", ["bcq", "uniform", "dequant", "ternary", "codebook"])
def test_serve_cli_continuous_each_format_on_cpu(capsys, fmt):
    serve.main(["--device", "cpu", "--requests", "3", "--gen", "3", "--prompt-len", "6",
                "--q", "2", "--g", "64", "--format", fmt, "--rate", "200"])
    out = capsys.readouterr().out
    assert f"{fmt} q=2 g=64" in out and "[continuous] 3 requests, 9 tokens" in out


def test_serve_modes_emit_the_same_tokens():
    """The continuous mode's completions equal the sequential mode's, request
    by request (greedy and sampled alike: each request is solo-identical)."""
    cfg = reduced(get_config("llama3.2-3b"), **SIZES)
    eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"), max_seq=24, device="cpu")
    reqs = serve.build_requests(cfg, 5, 6, 5)
    outs, _ = serve.drive_sequential(eng, reqs, np.zeros(5))
    _, done, _ = serve.drive_continuous(eng, serve.build_requests(cfg, 5, 6, 5), np.zeros(5),
                                        n_slots=2, chunk=3)
    by_rid = {c.rid: c.new_tokens for c in done}
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(by_rid[i], out.tokens[0, 6:])


def _format_engine(fmt, *, fuse=True, **policy):
    tcfg = reduced(get_config("llama3.2-3b"), **SIZES)
    params = init_params(tcfg, seed=1, device="cpu")
    qp = quantize_params(params, QuantPolicy(q=4, g=64, iters=2, fmt=fmt, **policy), device="cpu")
    return Engine(tcfg, qp, max_seq=32, fuse=fuse, device="cpu")


def test_uniform_and_dequant_greedy_tokens_identical():
    """The port's mirror of tests/test_formats.py::test_cross_format_greedy_tokens_identical."""
    toks = {fmt: _format_engine(fmt).generate(_prompts(), N).tokens for fmt in ("uniform", "dequant")}
    np.testing.assert_array_equal(toks["uniform"], toks["dequant"])


def test_uniform_fused_decode_matches_unfused():
    """The port's mirror of tests/test_formats.py::test_uniform_fused_decode_matches_unfused."""
    fused = _format_engine("uniform", fuse=True).generate(_prompts(), N)
    unfused = _format_engine("uniform", fuse=False).generate(_prompts(), N)
    np.testing.assert_array_equal(fused.tokens, unfused.tokens)


def test_mixed_format_model_decodes():
    """The port's mirror of tests/test_formats.py::test_mixed_format_model_decodes."""
    eng = _format_engine("bcq", attn=(4, 64, "uniform"), ffn=(3, 64, "bcq"))
    fmts = {leaf.fmt for leaf in tree_leaves(eng.params) if isinstance(leaf, QuantizedTensor)}
    assert fmts == {"uniform", "bcq"}
    res = eng.generate(_prompts()[:1, :6], 6)
    assert res.tokens.shape == (1, 12)


@pytest.mark.parametrize("argv,missing", [
    # --speculate is ported: its two cases hold the reference's refusals of
    # a dense model and of --sequential (ids kept from when it was refused)
    pytest.param(["--speculate", "2:4", "--q", "0"], "requires a quantized model", id="argv0-speculative"),
    pytest.param(["--sequential", "--speculate", "2:4"], "cannot be combined with --sequential",
                 id="argv1-speculative"),
    (["--sequential", "--tp", "2"], "tensor parallelism"),
    (["--sequential", "--prefix-cache-mb", "8"], "prefix cache"),
    (["--sequential", "--prefill-chunk", "4"], "chunked prefill"),
    (["--sequential", "--trace-out", "t.json"], "tracer"),
    (["--sequential", "--profile-dir", "p"], "profiler"),
    (["--tp", "2"], "tensor parallelism"),
    (["--prefill-chunk", "4"], "chunked prefill"),
    (["--sequential", "--prefix-block", "16"], "prefix cache"),
    (["--sequential", "--shared-prefix-len", "4"], "prefix cache"),
])
def test_serve_cli_refuses_unported_flags(capsys, argv, missing):
    """Flags of subsystems not ported yet, and combinations the reference's
    launcher refuses, exit with an argparse error naming the reason."""
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert missing in capsys.readouterr().err


_HYGIENE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run(
        [sys.executable, "-c", _HYGIENE], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25
    for path in [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, m)


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
