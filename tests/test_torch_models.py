"""Port parity: the dense decoder, quantization policy and fusion against the
JAX package on a reduced llama3.2-3b (the serve launcher's sizes: d_model
256, 4 kv heads, d_ff 512, 2 layers, vocab 256, f32), so every linear is
quantized.

Logits are compared with rtol = atol = 2e-5 in f32: the two packages
accumulate the same f32 products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro.quant import quantized_bytes as jquantized_bytes
from repro_torch.configs import get_config
from repro_torch.core.formats import get_format
from repro_torch.kernels import impl_mode
from repro_torch.models import (
    forward,
    fuse_decode_projections,
    init_cache,
    init_params,
    params_from_numpy,
    reduced,
)
from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes, truncate_params
from torch_helpers import jax_tree_to_numpy, quantized_paths

LOGIT_TOL = 2e-5
SIZES = dict(d_model=256, n_kv_heads=4, d_ff=512)
B, S, DECODE = 2, 8, 3


@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jget_config("llama3.2-3b"), **SIZES), reduced(get_config("llama3.2-3b"), **SIZES)


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jinit_params(jax.random.PRNGKey(0), cfgs[0])


@pytest.fixture(scope="module")
def jqparams(jparams):
    return jquantize_params(jparams, JPolicy(q=4, g=128, method="greedy"))


def _tokens():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, size=(B, S + DECODE)).astype(np.int32)


def _jax_logits(jcfg, params, toks):
    cache = jinit_cache(jcfg, B, S + DECODE + 1)
    out = []
    logits, cache, _ = jforward(
        jcfg, params, tokens=jnp.asarray(toks[:, :S]), cache=cache, pos=jnp.int32(0),
        logits_mode="last",
    )
    out.append(np.asarray(logits[:, -1]))
    for t in range(DECODE):
        logits, cache, _ = jforward(
            jcfg, params, tokens=jnp.asarray(toks[:, S + t : S + t + 1]), cache=cache,
            pos=jnp.int32(S + t), logits_mode="last",
        )
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out)


def _port_logits(cfg, params, toks, per_row_pos=False):
    cache = init_cache(cfg, B, S + DECODE + 1, device="cpu")
    tt = torch.from_numpy(toks).long()
    out = []
    with torch.no_grad():
        logits, cache = forward(cfg, params, tokens=tt[:, :S], cache=cache, pos=0, logits_mode="last")
        out.append(logits[:, -1].numpy())
        for t in range(DECODE):
            pos = torch.full((B,), S + t) if per_row_pos else S + t
            logits, cache = forward(
                cfg, params, tokens=tt[:, S + t : S + t + 1], cache=cache, pos=pos,
                logits_mode="last",
            )
            out.append(logits[:, -1].numpy())
    return np.stack(out)


def test_params_cross_bit_for_bit(jparams):
    tp = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jl:
        node = tp
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_bf16_leaves_cross_bit_for_bit():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8)), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "bcq_q4_g128"])
def test_forward_logits_match_jax(cfgs, jparams, jqparams, quantized):
    jcfg, tcfg = cfgs
    jp = jqparams if quantized else jparams
    toks = _tokens()
    want = _jax_logits(jcfg, jp, toks)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    got = _port_logits(tcfg, tp, toks)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # per-row positions give the scalar-position logits bit for bit
    np.testing.assert_array_equal(_port_logits(tcfg, tp, toks, per_row_pos=True), got)
    if quantized:  # the kernels' plain versions carry the same model
        for impl in ("bcq_mm", "lutgemm"):
            with impl_mode(impl):
                np.testing.assert_allclose(
                    _port_logits(tcfg, tp, toks), want, rtol=LOGIT_TOL, atol=LOGIT_TOL
                )


@pytest.mark.parametrize("fmt", ["uniform", "dequant", "ternary", "codebook"])
def test_format_forward_logits_match_jax(cfgs, jparams, fmt):
    """A reduced llama3.2-3b quantized by JAX in each format: the port's
    logits over a prefill and decode steps, on the ref oracle and through
    the format's kernel (its plain version on the CPU), fused and unfused."""
    jcfg, tcfg = cfgs
    jq = jquantize_params(jparams, JPolicy(q=4, g=128, iters=2, fmt=fmt))
    toks = _tokens()
    want = _jax_logits(jcfg, jq, toks)
    tp = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    assert {leaf.fmt for leaf in _qleaves(tp)} == {fmt}
    np.testing.assert_allclose(_port_logits(tcfg, tp, toks), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    kernel = get_format(fmt).impls[0]
    with impl_mode(kernel):
        for tree in (tp, fuse_decode_projections(tcfg, tp)):
            np.testing.assert_allclose(_port_logits(tcfg, tree, toks), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _qleaves(tree):
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.utils import tree_leaves

    return [leaf for leaf in tree_leaves(tree) if isinstance(leaf, QuantizedTensor)]


@pytest.mark.parametrize("fmt,planes,s_lead", [
    ("bcq", 4, 4), ("uniform", 4, 2), ("dequant", 4, 2), ("codebook", 4, 16), ("ternary", 2, 1),
])
def test_quantize_params_per_format_matches_jax_layout(cfgs, jparams, fmt, planes, s_lead):
    """Same leaves, planes (ternary stores 2 whatever q says) and scale
    planes as the JAX package; quantized_bytes agree."""
    _, tcfg = cfgs
    pol = dict(q=4, g=128, iters=1, method="greedy", fmt=fmt)
    jq = jquantize_params(jparams, JPolicy(**pol))
    tq = quantize_params(params_from_numpy(jax_tree_to_numpy(jparams), device="cpu"), QuantPolicy(**pol),
                         device="cpu")
    for leaf in _qleaves(tq):
        assert leaf.fmt == fmt and leaf.q == planes and leaf.scales.shape[-3] == s_lead
    assert quantized_bytes(tq) == jquantized_bytes(jq)
    fused = fuse_decode_projections(tcfg, tq)
    assert "wqkv" in fused["stages"][0]["b0"]["attn"] and quantized_bytes(fused) == quantized_bytes(tq)


def test_fused_params_give_same_logits(cfgs, jqparams):
    _, tcfg = cfgs
    tp = params_from_numpy(jax_tree_to_numpy(jqparams), device="cpu")
    fused = fuse_decode_projections(tcfg, tp)
    attn = fused["stages"][0]["b0"]["attn"]
    assert "wqkv" in attn and "wq" not in attn
    assert "w_gate_up" in fused["stages"][0]["b0"]["mlp"]
    assert quantized_bytes(fused) == quantized_bytes(tp)
    toks = _tokens()
    np.testing.assert_allclose(
        _port_logits(tcfg, fused, toks), _port_logits(tcfg, tp, toks), rtol=1e-6, atol=1e-6
    )
    dense = params_from_numpy(jax_tree_to_numpy(jinit_params(jax.random.PRNGKey(1), cfgs[0])), device="cpu")
    np.testing.assert_allclose(
        _port_logits(tcfg, fuse_decode_projections(tcfg, dense), toks),
        _port_logits(tcfg, dense, toks), rtol=1e-6, atol=1e-6,
    )


def test_quantize_params_same_leaves_groups_and_bytes(cfgs, jparams):
    """Same quantized paths with the same (q, g_eff); with the greedy solver
    the packed planes match bit for bit; quantized_bytes agree."""
    policy = dict(q=3, g=96, method="greedy", lm_head=(2, 64))
    jq = jquantize_params(jparams, JPolicy(**policy))
    tp = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    tq = quantize_params(tp, QuantPolicy(**policy), device="cpu")
    jpaths = {tuple(str(p) for p in k): v for k, v in quantized_paths(jq).items()}
    tpaths = {tuple(str(p) for p in k): v for k, v in quantized_paths(tq).items()}
    assert jpaths == tpaths and len(tpaths) == 8  # 7 block leaves + lm_head
    assert tpaths[("lm_head",)][:2] == (2, 64)
    assert tpaths[("stages", "0", "b0", "attn", "wq")][:2] == (3, 64)  # g_eff(256, 96) = 64
    assert quantized_bytes(tq) == jquantized_bytes(jq)
    assert quantized_bytes(tp) == jquantized_bytes(jparams)
    jw = jq["stages"][0]["b0"]["mlp"]["w_down"]
    tw = tq["stages"][0]["b0"]["mlp"]["w_down"]
    np.testing.assert_array_equal(tw.packed.numpy(), np.asarray(jw.packed))
    np.testing.assert_allclose(
        tw.scales.float().numpy(), np.asarray(jw.scales, np.float32), rtol=1e-2, atol=0
    )
    assert tw.scales.dtype == torch.bfloat16


def test_truncate_params_and_port_init(cfgs):
    _, tcfg = cfgs
    p = init_params(tcfg, seed=0, device="cpu")
    assert p["lm_head"].shape == (256, 256) and p["stages"][0]["b0"]["attn"]["wq"].shape == (2, 256, 256)
    q = quantize_params(p, QuantPolicy(q=4, g=128, method="greedy"), device="cpu")
    d = truncate_params(q, 2)
    assert d["lm_head"].q == 2 and q["lm_head"].q == 4
    assert d["embed"] is q["embed"]
    with pytest.raises(ValueError):
        truncate_params(q, 0)
    toks = _tokens()
    assert np.isfinite(_port_logits(tcfg, d, toks)).all()


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    cfg = reduced(get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        quantize_params({}, QuantPolicy())
