"""Port parity: the MoE family (olmoe-1b-7b, llama4-maverick-400b-a17b)
against the JAX package: the configs, ``moe_apply`` against the
reference's ``_moe_apply_global`` with identical routing, the packed expert
banks, the model through ``forward`` and ``Engine.generate``, the
refusals, the fusion rule and ``expert_matmul``'s plain paths.

Tolerances: 2e-5 for ``moe_apply`` with dense f32 experts (the packages
sum the same f32 products in other orders), 2e-4 with bcq experts and for
the model's logits (more products in a row), 1e-6 for the load-balance
loss; routing (top-k experts, kept assignments, buffer rows), packed bytes
and greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer.engine import Engine as JEngine
from repro.models import fuse as JF
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import moe as JM
from repro.models import reduced as jreduced
from repro.models.config import ModelConfig as JModelConfig
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.core.formats import format_names, get_format
from repro_torch.infer import Engine, PrefixCache, Scheduler, SpecConfig
from repro_torch.kernels import expert_linear, expert_matmul, impl_mode, launch_counts, reset_launch_counts
from repro_torch.kernels.expert_mm import expert_mm, expert_mm_pair, expert_mm_plain
from repro_torch.launch import serve
from repro_torch.models import forward, fuse_decode_projections, init_cache, init_params, params_from_numpy, reduced
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.quant.quantize import _quantize_leaf
from torch_helpers import jax_tree_to_numpy, quantized_paths

TOL = 2e-5
QTOL = 2e-4
ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head", "stages",
              "rope_theta", "n_experts", "top_k", "capacity_factor", "shared_expert", "moe_d_ff", "moe_period",
              "param_dtype", "compute_dtype")


def _close(got, want, tol=TOL, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=msg)


def _both(**kw):
    return JModelConfig(**kw), ModelConfig(**kw)


def _moe_kw(e=8, k=2, cf=1.25, shared=False, d=16, f=32):
    return dict(name="t", family="moe", n_layers=2, d_model=d, n_heads=2, n_kv_heads=2, d_ff=f, vocab=64,
                n_experts=e, top_k=k, capacity_factor=cf, shared_expert=shared, moe_d_ff=f,
                param_dtype="float32", compute_dtype="float32")


# -- the configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_has_the_reference_sizes(arch):
    jc, tc = jget_config(arch), get_config(arch)
    for f in CFG_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.block_counts() == jc.block_counts()


@pytest.mark.parametrize("arch,overrides", [
    ("olmoe-1b-7b", {}), ("olmoe-1b-7b", dict(n_layers=5, d_model=128, moe_d_ff=128)),
    ("llama4-maverick-400b-a17b", {}), ("llama4-maverick-400b-a17b", dict(n_layers=4, moe_period=2)),
    ("llama4-maverick-400b-a17b", dict(d_model=512, d_ff=1024, moe_d_ff=512, n_experts=128, top_k=1,
                                       moe_period=2, n_layers=4)),
])
def test_reduced_and_stages_match_the_reference(arch, overrides):
    """``reduced`` field for field (at most 8 experts, top-2, ``moe_d_ff``
    64, the shared expert kept, ``moe_period`` not carried), the stages
    included."""
    jr, tr = jreduced(jget_config(arch), **overrides), reduced(get_config(arch), **overrides)
    for f in CFG_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    if not overrides:
        assert tr.stages == ((("attn_moe",), 2),) and tr.moe_d_ff == 64 and tr.n_experts == 8


def test_period_stages_and_refusal_match_the_reference():
    jc, tc = _both(**{**_moe_kw(), "n_layers": 6, "moe_period": 3})
    assert tc.stages == jc.stages == ((("attn", "attn", "attn_moe"), 2),)
    for cls in (JModelConfig, ModelConfig):
        with pytest.raises(ValueError, match="must divide by period"):
            cls(**{**_moe_kw(), "n_layers": 5, "moe_period": 2})
    assert ModelConfig(**{**_moe_kw(), "moe_d_ff": None}).moe_d_ff == 32  # defaults to d_ff


@pytest.mark.parametrize("e,k,cf", [(64, 8, 1.25), (128, 1, 1.25), (8, 2, 1.25), (8, 2, 4.0), (8, 2, 0.1),
                                    (4, 1, 4.0)])
def test_capacity_matches_the_reference(e, k, cf):
    jc, tc = _both(**_moe_kw(e=e, k=k, cf=cf))
    assert [M.capacity(tc, t) for t in range(1, 601)] == [JM._capacity(jc, t) for t in range(1, 601)]


@pytest.mark.parametrize("arch,overrides", [("olmoe-1b-7b", {}), ("llama4-maverick-400b-a17b", dict(n_layers=4,
                                                                                                    moe_period=2))])
def test_init_params_have_the_reference_leaves(arch, overrides):
    """Every leaf of the port's ``init_params`` has the reference's path,
    shape and dtype: the f32 router ``(L, d, E)``, the banks ``(L, E, d,
    F)`` / ``(L, E, F, d)``, the shared expert's MLP."""
    jcfg, tcfg = jreduced(jget_config(arch), **overrides), reduced(get_config(arch), **overrides)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            return {p: v for key, sub in tree.items() for p, v in leaves(sub, path + (key,)).items()}
        if isinstance(tree, (tuple, list)):
            return {p: v for i, sub in enumerate(tree) for p, v in leaves(sub, path + (i,)).items()}
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}

    got, want = leaves(init_params(tcfg, seed=0, device="cpu")), leaves(jinit_params(jax.random.PRNGKey(0), jcfg))
    assert got == want
    assert any(p[-1] == "router" and v[1] == "float32" for p, v in got.items())
    assert any("shared" in p for p in got) == tcfg.shared_expert


# -- moe_apply against the reference's _moe_apply_global --------------------------


def _jax_routing(p, cfg, x):
    """The reference's routing, step by step as ``_moe_apply_global`` takes
    it: (top_e, keep, slot) in the sorted order."""
    t = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(t, -1)
    logits = jnp.dot(xf, p["router"].astype(xf.dtype), preferred_element_type=jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = jnp.bincount(flat_e, length=cfg.n_experts)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * cfg.top_k) - starts[se]
    keep = rank < JM._capacity(cfg, t)
    return np.asarray(top_e), np.asarray(keep), np.asarray(jnp.where(keep, rank, JM._capacity(cfg, t)))


def _port_routing(tp, cfg, x):
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    logits = M.linear(xf, tp["router"], out_dtype=torch.float32)
    _, top_e = M.route(logits, cfg.top_k)
    _, _, _, keep, slot, _ = M.dispatch(top_e, cfg.n_experts, M.capacity(cfg, xf.shape[0]))
    return top_e.numpy(), keep.numpy(), slot.numpy()


@pytest.mark.parametrize("e,k,cf,shared", [
    (8, 2, 4.0, False),  # no drop: cf = E / k
    (8, 2, 0.1, False),  # heavy dropping
    (8, 1, 8.0, True),  # top-1 with a shared expert (llama4's shape), no drop
    (8, 2, 0.1, True),
    (4, 1, 1.25, True),
])
def test_moe_apply_matches_jax(e, k, cf, shared):
    jc, tc = _both(**_moe_kw(e=e, k=k, cf=cf, shared=shared))
    p = JM.init_moe(jax.random.PRNGKey(e * 10 + k), jc)
    tp = params_from_numpy(jax_tree_to_numpy(p), device="cpu")
    x = np.random.default_rng(k).standard_normal((2, 16, 16)).astype(np.float32)
    jy, jaux = JM._moe_apply_global(p, jc, jnp.asarray(x))
    with torch.no_grad():
        ty, taux = M.moe_apply(tp, tc, torch.from_numpy(x), aux=True)
        ty2, none = M.moe_apply(tp, tc, torch.from_numpy(x))
    _close(ty, jy)
    assert none is None and torch.equal(ty, ty2)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    for name, got, want in zip(("top_e", "keep", "slot"), _port_routing(tp, tc, x), _jax_routing(p, jc, x)):
        np.testing.assert_array_equal(got, want, err_msg=name)
    if cf < 1:  # the heavy-dropping cases drop
        assert not _jax_routing(p, jc, x)[1].all()


@pytest.mark.parametrize("k,cf", [(2, 4.0), (2, 0.5), (2, 0.1), (1, 8.0), (4, 1.25)])
def test_bf16_moe_apply_equals_jax_bit_for_bit(k, cf):
    """In bf16 the port's MoE gives the reference's bits: buffers in x's
    dtype, gate and up in f32, ``silu(gate)·up`` and the output buffer cast
    to x's dtype, the routing weight cast before the product, the k
    contributions added in x's dtype in ascending expert order. (Without a
    shared expert: the dense MLP's bf16 products round elsewhere.)"""
    kw = {**_moe_kw(k=k, cf=cf, d=64, f=128), "param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    jc, tc = _both(**kw)
    p = JM.init_moe(jax.random.PRNGKey(1), jc)
    x = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(np.float32)
    jy, _ = JM._moe_apply_global(p, jc, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        ty, _ = M.moe_apply(params_from_numpy(jax_tree_to_numpy(p), device="cpu"), tc,
                            torch.from_numpy(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy, np.float32))


def test_moe_apply_matches_the_public_reference_entry():
    """Without a mesh the reference's ``moe_apply`` is ``_moe_apply_global``."""
    jc, tc = _both(**_moe_kw(shared=True))
    p = JM.init_moe(jax.random.PRNGKey(5), jc)
    x = np.random.default_rng(5).standard_normal((1, 9, 16)).astype(np.float32)
    jy, _ = JM.moe_apply(p, jc, jnp.asarray(x))
    with torch.no_grad():
        ty, _ = M.moe_apply(params_from_numpy(jax_tree_to_numpy(p), device="cpu"), tc, torch.from_numpy(x))
    _close(ty, jy)


@pytest.fixture(scope="module")
def quantized_bank():
    """The reference test's sizes (``tests/test_moe.py::test_quantized_experts``):
    4 experts, top-1, d_model = moe_d_ff = 128, bcq q = 4, g = 64, greedy."""
    jc, tc = _both(**_moe_kw(e=4, k=1, cf=4.0, d=128, f=128))
    p = JM.init_moe(jax.random.PRNGKey(0), jc)
    jq = jquantize_params({"mlp": p}, JPolicy(q=4, g=64, method="greedy"))["mlp"]
    tq = quantize_params({"mlp": params_from_numpy(jax_tree_to_numpy(p), device="cpu")},
                         QuantPolicy(q=4, g=64, method="greedy"), device="cpu")["mlp"]
    return jc, tc, jq, tq


def test_expert_banks_quantize_to_the_reference_bytes(quantized_bank):
    """Each ``(E, k, o)`` bank packs to the reference's planes and scales bit
    for bit; the router stays dense f32."""
    _, _, jq, tq = quantized_bank
    for name in ("w_gate", "w_up", "w_down"):
        assert tq[name].packed.shape == (4, 4, 16, 128) and tq[name].g == 64
        np.testing.assert_array_equal(tq[name].packed.numpy(), np.asarray(jq[name].packed), err_msg=name)
        np.testing.assert_array_equal(tq[name].scales.float().numpy(), np.asarray(jq[name].scales, np.float32))
    assert isinstance(tq["router"], torch.Tensor) and tq["router"].dtype == torch.float32


@pytest.mark.parametrize("mode", [None, "bcq_mm", "lutgemm"])
def test_moe_apply_with_bcq_experts_matches_jax(quantized_bank, mode):
    """The reference's dequantize-then-einsum (``_w``) against the port's
    oracle (``ref``, the CPU default) and its kernels' plain paths (K12's
    for ``bcq_mm``, K3's expert by expert for ``lutgemm``)."""
    jc, tc, jq, tq = quantized_bank
    x = np.random.default_rng(3).standard_normal((1, 8, 128)).astype(np.float32)
    jy, _ = JM._moe_apply_global(jq, jc, jnp.asarray(x))
    with torch.no_grad(), impl_mode(mode):
        ty, _ = M.moe_apply(params_from_numpy(jax_tree_to_numpy(jq), device="cpu"), tc, torch.from_numpy(x))
    _close(ty, jy, QTOL)


def test_topk_ties_route_as_lax_top_k():
    """Two experts whose router columns are equal tie on every token: the
    lower index comes first, as ``lax.top_k`` puts it."""
    jc, tc = _both(**_moe_kw(e=8, k=2, cf=8.0))
    p = dict(JM.init_moe(jax.random.PRNGKey(2), jc))
    r = np.array(p["router"])
    r[:, 5] = r[:, 2] = 3.0 * np.abs(r).max()  # experts 2 and 5 tie above the rest
    p["router"] = jnp.asarray(r)
    x = np.abs(np.random.default_rng(2).standard_normal((1, 12, 16))).astype(np.float32)
    jtop = _jax_routing(p, jc, x)[0]
    ttop = _port_routing(params_from_numpy(jax_tree_to_numpy(p), device="cpu"), tc, x)[0]
    assert (jtop == [2, 5]).all()
    np.testing.assert_array_equal(ttop, jtop)
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    _, top_e = M.route(torch.log(probs), 3)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_the_serial_scatter_add_in_expert_order(dtype):
    """The combine adds each token's k contributions in x's dtype in ascending
    expert order, the order of a serial scatter-add over the sorted list
    (the reference's ``.at[st].add`` on the CPU): bit for bit, and the same
    bits on a rerun."""
    cfg = ModelConfig(**{**_moe_kw(e=8, k=4, cf=0.5), "param_dtype": "float32", "compute_dtype": "float32"})
    gen = torch.Generator().manual_seed(0)
    p = M.init_moe(gen, cfg, device="cpu")
    x = torch.randn((3, 5, 16), generator=gen).to(dtype)
    out, _ = M.moe_apply(p, cfg, x)
    assert torch.equal(out, M.moe_apply(p, cfg, x)[0])
    # the serial scatter-add, from the same routing and expert outputs
    xf = x.reshape(15, 16)
    logits = M.linear(xf, p["router"], out_dtype=torch.float32)
    top_p, top_e = M.route(logits, cfg.top_k)
    cap = M.capacity(cfg, 15)
    order, se, st, keep, slot, _ = M.dispatch(top_e, cfg.n_experts, cap)
    buf = torch.zeros((8, cap + 1, 16), dtype=dtype)
    buf[se, slot] = xf[st]
    buf = buf[:, :cap]
    h = (torch.nn.functional.silu(expert_linear(buf, p["w_gate"])) * expert_linear(buf, p["w_up"])).to(dtype)
    out_buf = expert_linear(h, p["w_down"]).to(dtype)
    contrib = out_buf[se, torch.clamp_max(slot, cap - 1)] * (top_p.reshape(-1)[order] * keep).to(dtype)[:, None]
    want = torch.zeros((15, 16), dtype=dtype)
    for j in range(contrib.shape[0]):
        want[st[j]] = want[st[j]] + contrib[j]
    assert not keep.all()
    assert torch.equal(out.reshape(15, 16), want)


# -- the model through forward and Engine.generate ----------------------------------


MODELS = [("olmoe-1b-7b", {}), ("llama4-maverick-400b-a17b", {}),
          ("llama4-maverick-400b-a17b", dict(n_layers=4, moe_period=2))]


@pytest.fixture(scope="module", params=MODELS, ids=["olmoe", "llama4", "llama4-interleaved"])
def model(request):
    arch, kw = request.param
    jcfg, tcfg = jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _jax_run(jcfg, jp, toks, s, n):
    cache = jinit_cache(jcfg, toks.shape[0], s + n + 4)
    logits, cache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks[:, :s]), cache=cache, pos=jnp.int32(0),
                                logits_mode="last")
    out = [np.asarray(logits[:, -1])]
    for t in range(n):
        logits, cache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks[:, s + t : s + t + 1]), cache=cache,
                                    pos=jnp.int32(s + t), logits_mode="last")
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out)


def _port_run(tcfg, tp, toks, s, n):
    cache = init_cache(tcfg, toks.shape[0], s + n + 4, device="cpu")
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits, cache = forward(tcfg, tp, tokens=tt[:, :s], cache=cache, pos=0, logits_mode="last", prefill=True)
        out = [logits[:, -1].numpy()]
        for t in range(n):
            logits, cache = forward(tcfg, tp, tokens=tt[:, s + t : s + t + 1], cache=cache, pos=s + t,
                                    logits_mode="last")
            out.append(logits[:, -1].numpy())
    return np.stack(out)


def test_forward_logits_match_jax(model):
    """A 12-token prefill, then 6 decode steps (capacity couples each call's
    tokens the same way in both packages), and the train forward."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(0).integers(0, 256, (3, 18)).astype(np.int32)
    _close(_port_run(tcfg, tp, toks, 12, 6), _jax_run(jcfg, jp, toks, 12, 6), QTOL)
    want, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _ = forward(tcfg, tp, tokens=torch.from_numpy(toks).long())
    _close(got, want, QTOL)


def test_greedy_generate_equals_jax(model):
    """The port's greedy tokens equal the JAX engine's (batched), through the
    captured-step path and the eager loop."""
    jcfg, tcfg, jp, tp = model
    prompts = np.random.default_rng(7).integers(0, 256, (3, 10)).astype(np.int32)
    want = JEngine(jcfg, jp, max_seq=48).generate(prompts, 16).tokens
    eng = Engine(tcfg, tp, max_seq=48, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 16).tokens, want)
    np.testing.assert_array_equal(eng.generate(prompts, 16, scan=False).tokens, want)


def test_forward_quantized_matches_jax():
    """A 128-wide reduced olmoe with every bank, attention and LM head bcq
    packed by the reference (q = 4, g = 64): the banks cross as ``(L, E, q,
    k/8, o)`` leaves, the port's quantizer selects and packs the same leaves
    bit for bit, and logits agree on the ref path and through K12's plain
    version."""
    kw = dict(d_model=128, moe_d_ff=128, d_ff=256)
    jcfg, tcfg = jreduced(jget_config("olmoe-1b-7b"), **kw), reduced(get_config("olmoe-1b-7b"), **kw)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    jq = jquantize_params(jp, JPolicy(q=4, g=64, method="greedy"))
    tq = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    mine = quantize_params(params_from_numpy(jax_tree_to_numpy(jp), device="cpu"),
                           QuantPolicy(q=4, g=64, method="greedy"), device="cpu")
    assert quantized_paths(mine) == quantized_paths(jq)
    bank = tq["stages"][0]["b0"]["mlp"]["w_up"]
    assert tuple(bank.packed.shape) == (2, 8, 4, 16, 128)
    assert torch.equal(mine["stages"][0]["b0"]["mlp"]["w_up"].packed, bank.packed)
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    want = _jax_run(jcfg, jq, toks, 12, 4)
    _close(_port_run(tcfg, tq, toks, 12, 4), want, QTOL)
    reset_launch_counts()
    with impl_mode("bcq_mm"):
        _close(_port_run(tcfg, tq, toks, 12, 4), want, QTOL)
    assert launch_counts()["expert_mm"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_at_no_drop_capacity(arch):
    """The reference's ``test_moe_consistency_at_no_drop_capacity``
    (``tests/test_models.py``) in the port: at ``cf = E / k`` nothing drops,
    so a cached prefill of S - 1 tokens gives the no-cache forward's logits
    at S - 2 (1e-3, the reference's bound)."""
    base = reduced(get_config(arch))
    cfg = reduced(get_config(arch), capacity_factor=float(base.n_experts / base.top_k))
    p = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))).long()
    with torch.no_grad():
        full, _ = forward(cfg, p, tokens=toks)
        lp, _ = forward(cfg, p, tokens=toks[:, :15], cache=init_cache(cfg, 2, 16, device="cpu"), pos=0,
                        logits_mode="last", prefill=True)
    _close(lp[:, 0], full[:, 14].numpy(), 1e-3)


# -- fusion --------------------------------------------------------------------------


def test_fusion_keeps_the_expert_banks_and_fuses_attention_as_the_reference():
    """``wqkv`` is fused in every ``attn_moe`` block; the expert MLP (its
    banks and the shared expert) is left as it is (``router`` present), and
    the dense blocks of an interleaved model fuse ``w_gate_up``, as the
    reference fuses them; bcq banks keep ``(L, E, ...)`` leaves."""
    kw = dict(n_layers=4, moe_period=2, d_model=256, moe_d_ff=128, d_ff=256)  # K/V 128 wide: packed
    arch = "llama4-maverick-400b-a17b"
    jcfg, tcfg = jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)
    jq = jquantize_params(jinit_params(jax.random.PRNGKey(0), jcfg), JPolicy(q=4, g=64, method="greedy"))
    want = JF.fuse_decode_projections(jcfg, jq)
    got = fuse_decode_projections(tcfg, params_from_numpy(jax_tree_to_numpy(jq), device="cpu"))
    assert quantized_paths(got) == quantized_paths(want)
    moe_blk = got["stages"][0]["b1"]
    assert "wqkv" in moe_blk["attn"] and set(moe_blk["mlp"]) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert set(moe_blk["mlp"]["shared"]) == {"w_gate", "w_up", "w_down"}
    assert "w_gate_up" in got["stages"][0]["b0"]["mlp"]
    assert moe_blk["mlp"]["w_gate"].packed.dim() == 5


# -- refusals ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_engine():
    cfg = reduced(get_config("olmoe-1b-7b"))
    return Engine(cfg, init_params(cfg, seed=0, device="cpu"), max_seq=32, device="cpu")


def test_slots_are_refused_naming_moe(moe_engine):
    with pytest.raises(ValueError, match="slot-batched serving does not support MoE models: shared expert "
                                         "capacity couples batch rows"):
        moe_engine.init_slots(2)
    with pytest.raises(ValueError, match="does not support MoE"):
        Scheduler(moe_engine, n_slots=2).run()


def test_speculation_is_refused_naming_moe():
    cfg = reduced(get_config("olmoe-1b-7b"), d_model=128, moe_d_ff=128, d_ff=256)
    params = quantize_params(init_params(cfg, seed=0, device="cpu"), QuantPolicy(q=4, g=64, iters=1), device="cpu")
    eng = Engine(cfg, params, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="speculative decoding does not support MoE models: shared expert "
                                         "capacity couples the verified chunk's tokens, so the batched verify "
                                         "is not equivalent to step-by-step decode"):
        eng.generate(np.zeros((1, 4), np.int64), 4, speculate=SpecConfig(2, 2))


def test_prefix_cache_is_refused_naming_moe():
    cfg = reduced(get_config("olmoe-1b-7b"))
    with pytest.raises(ValueError, match="prefix_cache requires a tokens-input, non-VLM, non-MoE model"):
        Engine(cfg, init_params(cfg, seed=0, device="cpu"), max_seq=32, device="cpu", prefix_cache=PrefixCache())


def test_chunked_prefill_is_refused_naming_moe(moe_engine):
    assert not moe_engine.supports_chunked_prefill
    why = r"chunked prefill is unsupported for this architecture \(ring-buffer/recurrent/MoE/VLM"
    with pytest.raises(ValueError, match=why):
        moe_engine.begin_admission(np.arange(6), max_new_tokens=2, chunked=True)
    with pytest.raises(ValueError, match=why):
        Scheduler(moe_engine, n_slots=2, prefill_chunk=4)


def test_serve_cli_refuses_continuous_moe_and_serves_sequential(capsys):
    with pytest.raises(ValueError, match="does not support MoE models"):
        serve.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--requests", "2", "--gen", "2"])
    serve.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--sequential", "--requests", "2", "--gen", "4",
                "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "[sequential] 2 requests" in out and "sample:" in out


# -- expert_matmul's plain paths -----------------------------------------------------


@pytest.mark.parametrize("fmt", sorted(format_names()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_expert_matmul_plain_paths_match_per_expert_dequantize(fmt, dtype):
    """Every format, on the oracle and on each of its kernels' plain paths:
    each expert's rows against its own dequantized weight and a dot
    (2e-4); a dense bank through one batched product."""
    gen = torch.Generator().manual_seed(len(fmt))
    w = torch.randn((3, 128, 192), generator=gen) / 12
    qt = _quantize_leaf(w, 4, 64, fmt, QuantPolicy(iters=2))
    buf = torch.randn((3, 8, 128), generator=gen).to(dtype)
    f = get_format(fmt)
    want = torch.stack([buf[e].float() @ f.dequantize(qt.replace(packed=qt.packed[e], scales=qt.scales[e]))
                        for e in range(3)])
    for impl in ("ref",) + f.impls:
        got = expert_matmul(fmt, buf, qt, impl=impl)
        assert got.dtype == torch.float32 and got.shape == (3, 8, 192)
        ref_w = want if impl != "ref" else torch.stack([buf[e].float() @ f.dequantize(
            qt.replace(packed=qt.packed[e], scales=qt.scales[e]), dtype=dtype).float() for e in range(3)])
        _close(got, ref_w, QTOL, msg=f"{fmt} {impl}")
    dense = expert_linear(buf, w.to(dtype))
    _close(dense, torch.bmm(buf.float(), w.to(dtype).float()), 1e-6)


def test_expert_mm_plain_is_each_experts_plain_kernel_and_validates():
    from repro_torch.kernels import bcq_mm_plain

    gen = torch.Generator().manual_seed(0)
    packed = torch.randint(0, 256, (5, 3, 16, 96), generator=gen, dtype=torch.uint8)
    scales = torch.rand((5, 3, 2, 96), generator=gen)
    x = torch.randn((5, 7, 128), generator=gen)
    got = expert_mm(x, packed, scales, g=64)
    assert torch.equal(got, expert_mm_plain(x, packed, scales, g=64))
    for e in range(5):
        assert torch.equal(got[e], bcq_mm_plain(x[e], packed[e], scales[e], g=64))
    with pytest.raises(ValueError, match="group-table kinds"):
        expert_mm(x, packed, scales, g=64, kind="codebook")
    with pytest.raises(ValueError, match="expert counts"):
        expert_mm(x[:4], packed, scales, g=64)
    with pytest.raises(ValueError, match="scales shape"):
        expert_mm(x, packed, scales[:, :2], g=64)
    with pytest.raises(ValueError, match="exactly 2 planes"):
        expert_mm(x, packed, scales[:, :1], g=64, kind="ternary")
    with pytest.raises(ValueError, match="does not lead"):
        expert_matmul("bcq", x[:4], _quantize_leaf(torch.randn(5, 128, 96), 3, 64, "bcq", QuantPolicy(iters=1)),
                      impl="ref")


def test_expert_mm_plain_zeroes_rows_past_each_experts_count():
    """``rows`` zeroes expert e's rows at or past ``rows[e]`` (an empty
    expert entirely, a count past C none) and leaves every other row the
    plain result bit for bit; the pair gives each bank's own result."""
    gen = torch.Generator().manual_seed(1)
    packed = torch.randint(0, 256, (4, 4, 16, 64), generator=gen, dtype=torch.uint8)
    scales = torch.rand((4, 4, 2, 64), generator=gen)
    x = torch.randn((4, 6, 128), generator=gen)
    whole = expert_mm(x, packed, scales, g=64)
    rows = torch.tensor([0, 3, 6, 9], dtype=torch.int32)
    got = expert_mm(x, packed, scales, g=64, rows=rows)
    assert torch.equal(got, expert_mm_plain(x, packed, scales, g=64, rows=rows))
    for e, n in enumerate([0, 3, 6, 6]):
        assert torch.equal(got[e, :n], whole[e, :n]) and not got[e, n:].any()
    assert torch.equal(expert_mm(x, packed, scales, g=64, rows=torch.full((4,), 6, dtype=torch.int32)), whole)
    other = (packed.flip(0), scales.flip(0))
    a, b = expert_mm_pair(x, (packed, scales), other, g=64, rows=rows)
    assert torch.equal(a, got) and torch.equal(b, expert_mm(x, *other, g=64, rows=rows))
    with pytest.raises(ValueError, match="rows must be"):
        expert_mm(x, packed, scales, g=64, rows=rows.long())
    with pytest.raises(ValueError, match="the banks differ"):
        expert_mm_pair(x, (packed, scales), (packed, scales.to(torch.bfloat16)), g=64)


def test_dispatch_rows_are_the_clamped_counts():
    """``dispatch``'s last result is each expert's filled buffer rows: its
    assignments, at most the capacity, int32 on the routing's device."""
    top_e = torch.tensor([[0, 2], [2, 0], [2, 3], [2, 1]])
    order, se, st, keep, slot, rows = M.dispatch(top_e, 5, 3)
    assert rows.dtype == torch.int32 and rows.tolist() == [2, 1, 3, 1, 0]
    assert rows.tolist() == [int(((se == e) & keep).sum()) for e in range(5)]


@pytest.mark.parametrize("mode,paired", [("bcq_mm", True), (None, False), ("lutgemm", False)])
def test_gate_and_up_pair_only_on_the_grouped_kernel(quantized_bank, mode, paired, monkeypatch):
    """``moe_apply`` runs gate and up as one pair where both banks take K12
    (``bcq_mm``); the oracle and the expert-by-expert kernels (``lutgemm``)
    take two ``expert_linear`` calls, as before. Either way the result is
    the two single products'."""
    import importlib

    EM = importlib.import_module("repro_torch.kernels.expert_mm")  # the package re-exports the function
    ops = importlib.import_module("repro_torch.kernels.ops")

    jc, tc, jq, tq = quantized_bank
    p = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    calls = {"pair": 0, "single": 0}
    real_pair, real_single = EM.expert_mm_pair, ops.expert_linear

    def pair(*a, **kw):
        calls["pair"] += 1
        return real_pair(*a, **kw)

    def single(*a, **kw):
        calls["single"] += 1
        return real_single(*a, **kw)

    monkeypatch.setattr(EM, "expert_mm_pair", pair)
    monkeypatch.setattr(ops, "expert_linear", single)
    buf = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 8, 128)).astype(np.float32))
    rows = torch.tensor([8, 0, 3, 5], dtype=torch.int32)
    with impl_mode(mode):
        gate, up = ops.expert_linear_pair(buf, p["w_gate"], p["w_up"], rows=rows)
        want = [real_single(buf, p[n], rows=rows) for n in ("w_gate", "w_up")]
    assert calls == ({"pair": 1, "single": 0} if paired else {"pair": 0, "single": 2})
    assert torch.equal(gate, want[0]) and torch.equal(up, want[1])
    dense_gate, dense_up = ops.expert_linear_pair(buf, torch.randn(4, 128, 64), torch.randn(4, 128, 64))
    assert dense_gate.shape == dense_up.shape == (4, 8, 64)
