"""Port parity: the vlm family, llama-3.2-vision-90b (4 ``attn`` blocks and
a ``cross`` block every 5 layers over a stub vision tower's image
embeddings), against the JAX package on the reference's reduced config (one
period of 5 layers, d_model 64, 8 image tokens, f32; a 128-wide variant
where quantization must bite), and the port's own invariants on it.

Against JAX: rtol = atol = 2e-4 for the cross block and the logits (the
packages sum the same f32 products in other orders), the reference's own
5e-4 for cached prefill + decode against the no-cache forward
(``tests/test_models.py``); configs, stages, parameter leaves, packed
bytes and greedy tokens exactly. Inside the port, bit for bit: speculative
== plain greedy, a verify's rows == decode steps, and the image memory
(``k_img`` / ``v_img``) unchanged by decode steps and verifies.
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
from repro.models import model as JModel
from repro.models import reduced as jreduced
from repro.models.config import ModelConfig as JModelConfig
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.infer import Engine, PrefixCache, Scheduler, SpecConfig
from repro_torch.infer import speculative as S
from repro_torch.kernels import impl_mode, launch_counts, reset_launch_counts
from repro_torch.launch import serve
from repro_torch.models import forward, fuse_decode_projections, init_cache, init_params, params_from_numpy, reduced
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.quant import QuantPolicy, quantize_params
from torch_helpers import jax_tree_to_numpy, quantized_paths

TOL = 2e-4
TRAIN_TOL = 5e-4  # the reference's bound for the vlm arch (tests/test_models.py)
ARCH = "llama-3.2-vision-90b"
WIDE = dict(d_model=128, n_kv_heads=4, d_ff=256)  # every linear >= 128 wide: each one packed
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head", "stages",
              "rope_theta", "cross_attn_period", "n_image_tokens", "input_kind", "param_dtype", "compute_dtype",
              "kv_cache_dtype")
B = 2


def _close(got, want, tol=TOL, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=msg)


def _cfgs(**kw):
    return jreduced(jget_config(ARCH), **kw), reduced(get_config(ARCH), **kw)


def _image(cfg, seed=0, b=B):
    return np.random.default_rng(seed).standard_normal((b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


# -- the configs ------------------------------------------------------------------


def test_config_has_the_reference_sizes():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    for f in CFG_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.block_counts() == jc.block_counts() == {"attn": 80, "cross": 20}
    assert ARCH in ARCH_IDS


@pytest.mark.parametrize("overrides", [{}, dict(n_layers=10), dict(cross_attn_period=2, n_layers=4),
                                       dict(d_model=128, n_image_tokens=3)])
def test_reduced_and_stages_match_the_reference(overrides):
    """``reduced`` field for field: one period of layers (the reference's
    ``cross_attn_period``), 8 image tokens, ``input_kind`` carried."""
    jr, tr = _cfgs(**overrides)
    for f in CFG_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    if not overrides:
        assert tr.stages == ((("attn", "attn", "attn", "attn", "cross"), 1),) and tr.n_image_tokens == 8


@pytest.mark.parametrize("n_layers,period", [(5, 5), (10, 5), (3, 3), (7, 5), (4, 3)])
def test_period_stages_and_refusal_match_the_reference(n_layers, period):
    kw = dict(name="x", family="vlm", n_layers=n_layers, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
              cross_attn_period=period)
    if n_layers % period:
        for cls in (JModelConfig, ModelConfig):
            with pytest.raises(ValueError, match=f"vlm layers {n_layers} must divide by period {period}"):
                cls(**kw)
        return
    assert ModelConfig(**kw).stages == JModelConfig(**kw).stages


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for key, sub in tree.items() for p, v in _leaves(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, sub in enumerate(tree) for p, v in _leaves(sub, path + (i,)).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_init_params_and_cache_have_the_reference_leaves(kv_cache_dtype):
    """Parameters: the cross block has the ``attn`` block's leaves. Cache:
    the cross block's ``k_img`` / ``v_img`` ``(repeat, B, n_image_tokens,
    Hkv, Dh)`` in the cache dtype, kept there under an int8 KV cache."""
    jc, tc = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16", kv_cache_dtype=kv_cache_dtype)
    assert _leaves(init_params(tc, seed=0, device="cpu")) == _leaves(jinit_params(jax.random.PRNGKey(0), jc))
    got, want = _leaves(init_cache(tc, B, 24, device="cpu")), _leaves(jinit_cache(jc, B, 24))
    assert got == want
    assert got[("stages", 0, "b4", "k_img")] == ((1, B, 8, 2, 16), "bfloat16")


# -- the cross block against the reference's apply_block -------------------------


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _block_params(jp, l=0):
    return jax.tree.map(lambda x: x[l], jp["stages"][0]["b4"])


def test_cross_block_matches_apply_block(model):
    """The cross block alone: without a cache (train), at a prefill that
    writes the image memory into the cache, and at a decode step that
    reads it back (2e-4); the stored memory is the reference's."""
    jcfg, tcfg, jp, _ = model
    bp = _block_params(jp)
    tbp = params_from_numpy(jax_tree_to_numpy(bp), device="cpu")
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B, 6, 64)).astype(np.float32)
    img = _image(tcfg, 2)
    positions = np.broadcast_to(np.arange(6, dtype=np.int32), (B, 6))
    want, _, _ = JModel.apply_block(bp, jcfg, "cross", jnp.asarray(h), jnp.asarray(positions), None, None,
                                    jnp.asarray(img))
    with torch.no_grad():
        got, _ = M.apply_block(tbp, tcfg, "cross", torch.from_numpy(h), torch.from_numpy(positions.copy()).long(),
                               None, None, torch.from_numpy(img))
    _close(got, want)
    jcache = jax.tree.map(lambda x: x[0], jinit_cache(jcfg, B, 16)["stages"][0]["b4"])
    tcache = M.layer_slice(init_cache(tcfg, B, 16, device="cpu")["stages"][0]["b4"], 0)
    want_p, jcache, _ = JModel.apply_block(bp, jcfg, "cross", jnp.asarray(h), jnp.asarray(positions), jcache,
                                           jnp.int32(0), jnp.asarray(img))
    h1 = rng.standard_normal((B, 1, 64)).astype(np.float32)
    want_d, _, _ = JModel.apply_block(bp, jcfg, "cross", jnp.asarray(h1), jnp.full((B, 1), 6, jnp.int32), jcache,
                                      jnp.int32(6), None)
    with torch.no_grad():
        got_p, tcache = M.apply_block(tbp, tcfg, "cross", torch.from_numpy(h), torch.from_numpy(positions.copy()).long(),
                                      tcache, 0, torch.from_numpy(img))
        got_d, _ = M.apply_block(tbp, tcfg, "cross", torch.from_numpy(h1), torch.full((B, 1), 6), tcache, 6, None)
    _close(got_p, want_p)
    _close(got_d, want_d)
    for name in ("k_img", "v_img"):
        _close(tcache[name], jcache[name], msg=name)
    with pytest.raises(ValueError, match="needs image_emb"):
        M.apply_block(tbp, tcfg, "cross", torch.from_numpy(h), torch.from_numpy(positions.copy()).long(), None, None)


def test_queries_take_rope_and_the_image_keys_none(model):
    """The same query row at another position attends the same memory
    otherwise: its output moves (RoPE on q); the memory's keys are the bare
    ``wk`` projection of the image rows (no RoPE)."""
    _, tcfg, _, tp = model
    bp = M.layer_slice(tp["stages"][0]["b4"], 0)["attn"]
    img = torch.from_numpy(_image(tcfg, 3))
    k, v = M.image_memory(bp, tcfg, None, None, img)
    assert torch.equal(k, (img @ bp["wk"]).reshape(B, 8, 2, 16))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, 1, 64)).astype(np.float32))
    at = [L.attention(bp, tcfg, x, torch.full((B, 1), p), kv_override=(k, v))[0] for p in (0, 5)]
    assert not torch.allclose(at[0], at[1])


# -- the model through forward and Engine.generate ----------------------------------


def _jax_run(jcfg, jp, toks, img, s, n):
    cache = jinit_cache(jcfg, toks.shape[0], s + n + 4)
    logits, cache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks[:, :s]), image_emb=jnp.asarray(img), cache=cache,
                                pos=jnp.int32(0), logits_mode="last")
    out = [np.asarray(logits[:, -1])]
    for t in range(n):
        logits, cache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks[:, s + t : s + t + 1]), image_emb=None,
                                    cache=cache, pos=jnp.int32(s + t), logits_mode="last")
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out)


def _port_run(tcfg, tp, toks, img, s, n):
    cache = init_cache(tcfg, toks.shape[0], s + n + 4, device="cpu")
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits, cache = forward(tcfg, tp, tokens=tt[:, :s], image_emb=torch.from_numpy(img), cache=cache, pos=0,
                                logits_mode="last", prefill=True)
        out = [logits[:, -1].numpy()]
        for t in range(n):
            logits, cache = forward(tcfg, tp, tokens=tt[:, s + t : s + t + 1], cache=cache, pos=s + t,
                                    logits_mode="last")
            out.append(logits[:, -1].numpy())
    return np.stack(out)


def test_forward_logits_match_jax(model):
    """A 12-token prefill given the image embeddings, 6 decode steps that
    read the stored memory, and the train forward."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(0).integers(0, 256, (B, 18)).astype(np.int32)
    img = _image(tcfg, 5)
    _close(_port_run(tcfg, tp, toks, img, 12, 6), _jax_run(jcfg, jp, toks, img, 12, 6))
    want, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks), image_emb=jnp.asarray(img))
    with torch.no_grad():
        got, _ = forward(tcfg, tp, tokens=torch.from_numpy(toks).long(), image_emb=torch.from_numpy(img))
    _close(got, want)


def test_prefill_decode_matches_train_forward(model):
    """The reference's ``test_prefill_decode_matches_train_forward`` for this
    arch in the port (B 2, S 32, 5e-4), on the weights carried across, and
    the port's numbers against the reference's own."""
    jcfg, tcfg, jp, tp = model
    s = 32
    toks = np.random.default_rng(11).integers(0, 256, (B, s)).astype(np.int32)
    img = torch.from_numpy(_image(tcfg, 12))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        full, _ = forward(tcfg, tp, tokens=tt, image_emb=img)
        cache = init_cache(tcfg, B, s, device="cpu")
        lp, cache = forward(tcfg, tp, tokens=tt[:, : s - 1], image_emb=img, cache=cache, pos=0, logits_mode="last",
                            prefill=True)
        lp2, _ = forward(tcfg, tp, tokens=tt[:, s - 1 :], cache=cache, pos=s - 1, logits_mode="last")
    _close(lp[:, 0], full[:, s - 2].numpy(), TRAIN_TOL)
    _close(lp2[:, 0], full[:, s - 1].numpy(), TRAIN_TOL)
    want, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks), image_emb=jnp.asarray(img.numpy()))
    _close(full, want)


def test_a_prefill_without_image_embeddings_attends_zeros(model):
    """The reference's VLM prefill without ``image_emb`` reads the fresh
    cache's zeroed memory; the port's gives the same logits and equals
    zeroed image embeddings bit for bit."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(6).integers(0, 256, (B, 9)).astype(np.int32)
    want, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks), image_emb=None, cache=jinit_cache(jcfg, B, 16),
                          pos=jnp.int32(0), logits_mode="last")
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        got, _ = forward(tcfg, tp, tokens=tt, cache=init_cache(tcfg, B, 16, device="cpu"), pos=0, logits_mode="last",
                         prefill=True)
        zero, _ = forward(tcfg, tp, tokens=tt, image_emb=torch.zeros((B, 8, 64)),
                          cache=init_cache(tcfg, B, 16, device="cpu"), pos=0, logits_mode="last", prefill=True)
    _close(got, want)
    assert torch.equal(got, zero)


def test_image_embeddings_are_not_cast_to_the_compute_dtype():
    """As in the reference, a bf16 model projects f32 image embeddings in
    f32: the prefill attends that f32 memory and the cache stores it rounded
    to bf16, not the projection of the embeddings rounded first."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jinit_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    img = _image(tcfg, 7)
    toks = np.random.default_rng(8).integers(0, 256, (B, 6)).astype(np.int32)
    with torch.no_grad():
        cache = init_cache(tcfg, B, 8, device="cpu")
        got, cache = forward(tcfg, tp, tokens=torch.from_numpy(toks).long(), image_emb=torch.from_numpy(img),
                             cache=cache, pos=0, logits_mode="last", prefill=True)
    wk = M.layer_slice(tp["stages"][0]["b4"], 0)["attn"]["wk"]
    f32 = (torch.from_numpy(img) @ wk.float()).reshape(B, 8, 2, 16)
    assert cache["stages"][0]["b4"]["k_img"].dtype == torch.bfloat16
    assert torch.equal(cache["stages"][0]["b4"]["k_img"][0], f32.to(torch.bfloat16))
    assert not torch.equal(f32.to(torch.bfloat16), (torch.from_numpy(img).bfloat16() @ wk).reshape(B, 8, 2, 16))
    want, jcache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks), image_emb=jnp.asarray(img),
                               cache=jinit_cache(jcfg, B, 8), pos=jnp.int32(0), logits_mode="last")
    _close(cache["stages"][0]["b4"]["k_img"], jcache["stages"][0]["b4"]["k_img"], 1e-2)
    scale = float(np.abs(np.asarray(want)).max())
    assert float((got - torch.from_numpy(np.array(want))).abs().max()) <= 2e-2 * scale


def test_greedy_generate_equals_jax(model):
    """The port's greedy tokens equal the JAX engine's (batched, image
    embeddings given), through the captured-step path and the eager loop;
    and without image embeddings (zeroed memory)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, 256, (3, 10)).astype(np.int32)
    img = _image(tcfg, 9, b=3)
    jeng = JEngine(jcfg, jp, max_seq=48)
    eng = Engine(tcfg, tp, max_seq=48, device="cpu")
    want = jeng.generate(prompts, 16, image_emb=img).tokens
    np.testing.assert_array_equal(eng.generate(prompts, 16, image_emb=img).tokens, want)
    np.testing.assert_array_equal(eng.generate(prompts, 16, image_emb=img, scan=False).tokens, want)
    np.testing.assert_array_equal(eng.generate(prompts, 16).tokens, jeng.generate(prompts, 16).tokens)


# -- quantized --------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized():
    """The 128-wide reduced model, bcq q = 4, g = 64 (greedy solver),
    quantized by the reference and by the port."""
    jcfg, tcfg = _cfgs(**WIDE)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    jq = jquantize_params(jp, JPolicy(q=4, g=64, method="greedy"))
    mine = quantize_params(params_from_numpy(jax_tree_to_numpy(jp), device="cpu"),
                           QuantPolicy(q=4, g=64, method="greedy"), device="cpu")
    return jcfg, tcfg, jq, mine


def test_cross_leaves_quantize_to_the_reference_bytes(quantized):
    """The port's quantizer selects the reference's leaves (the cross block's
    ``wq`` / ``wk`` / ``wv`` / ``wo`` among them) and packs them bit for bit."""
    _, _, jq, mine = quantized
    assert quantized_paths(mine) == quantized_paths(jq)
    cross, jcross = mine["stages"][0]["b4"]["attn"], jq["stages"][0]["b4"]["attn"]
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(cross[name].packed.numpy(), np.asarray(jcross[name].packed), err_msg=name)
        np.testing.assert_array_equal(cross[name].scales.float().numpy(), np.asarray(jcross[name].scales, np.float32),
                                      err_msg=name)


@pytest.mark.parametrize("mode", ["ref", "bcq_mm"])
def test_forward_quantized_matches_jax(quantized, mode):
    """Logits of a 12-token prefill given image embeddings and 4 decode steps
    on the packed weights, on the oracle and through K1/K2's plain versions
    (CPU tensors run the plain version: no launch), against the reference's
    ``qmatmul(impl="ref")`` (2e-4)."""
    jcfg, tcfg, jq, _ = quantized
    tq = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (B, 16)).astype(np.int32)
    img = _image(tcfg, 10)
    want = _jax_run(jcfg, jq, toks, img, 12, 4)
    reset_launch_counts()
    with impl_mode(mode):
        _close(_port_run(tcfg, tq, toks, img, 12, 4), want)
    assert launch_counts()["bcq_mm"] == 0


def test_the_cross_block_is_never_fused(quantized):
    """Fusion as the reference's: ``wqkv`` and ``w_gate_up`` in the ``attn``
    blocks, the cross block's MLP fused too, its ``wq`` / ``wk`` / ``wv``
    left apart (they reach K1 one by one)."""
    jcfg, tcfg, jq, mine = quantized
    got = fuse_decode_projections(tcfg, mine)
    assert quantized_paths(got) == quantized_paths(JF.fuse_decode_projections(jcfg, jq))
    cross = got["stages"][0]["b4"]
    assert set(cross["attn"]) == {"wq", "wk", "wv", "wo"} and "w_gate_up" in cross["mlp"]
    assert "wqkv" in got["stages"][0]["b0"]["attn"]


@pytest.fixture(scope="module")
def qengine(quantized):
    _, tcfg, _, mine = quantized
    return Engine(tcfg, mine, max_seq=64, device="cpu")


@pytest.mark.parametrize("spec", [(2, 3), (1, 4), (4, 2)])
def test_speculative_equals_plain_greedy(qengine, spec):
    """Greedy speculative tokens equal plain greedy tokens (both prefills
    given the image embeddings); a draft equal to the target accepts every
    committable proposal."""
    rng = np.random.default_rng(spec[0])
    prompts = rng.integers(0, 256, (2, 9))
    img = _image(qengine.cfg, 20 + spec[1])
    plain = qengine.generate(prompts, 14, image_emb=img)
    res = qengine.generate(prompts, 14, image_emb=img, speculate=SpecConfig(*spec))
    np.testing.assert_array_equal(res.tokens, plain.tokens)
    if spec[0] == 4:
        assert res.spec_stats["accepted"] == res.spec_stats["committable"]


def test_image_memory_is_unchanged_by_decode_steps_and_verifies(qengine):
    """``k_img`` / ``v_img`` are static: decode steps, a verify and a chunk
    with rejected proposals leave them bit for bit as the prefill wrote
    them, in the target's cache and the draft's; a verify's rows equal
    decode steps'."""
    cfg = qengine.cfg
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 8)))
    img = torch.from_numpy(_image(cfg, 31))
    _, cache = qengine.prefill(prompts, qengine._make_cache(2), img)
    draft = qengine.draft_params(1)
    _, dcache = forward(cfg, draft, tokens=prompts, image_emb=img, cache=qengine._make_cache(2), pos=0,
                        logits_mode="last", prefill=True)
    memory = [(c["stages"][0]["b4"]["k_img"].clone(), c["stages"][0]["b4"]["v_img"].clone()) for c in (cache, dcache)]
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 4)))
    steps = []
    c2 = qengine._make_cache(2)
    qengine.prefill(prompts, c2, img)
    for i in range(4):
        lg, c2 = qengine.decode(toks[:, i : i + 1], c2, 8 + i)
        steps.append(lg)
    with torch.no_grad():
        verify, _ = forward(cfg, qengine.params, tokens=toks, cache=cache, pos=8, logits_mode="all",
                            chunked_decode=True)
    assert torch.equal(verify, torch.stack(steps, dim=1))
    state = {"t_pend": toks[:, 0], "pos": np.full((2,), 12, np.int64), "cache": cache, "draft_cache": dcache,
             "logits": verify[:, -1]}
    _, n_keep, _ = S.spec_chunk(cfg, qengine.params, draft, state, gamma=4, greedy=np.ones(2, bool),
                                temperature=np.ones(2), spec_enabled=np.ones(2, bool), active=np.ones(2, bool),
                                gens=[None, None], draft_gens=[None, None], fwd=qengine._fwd)
    assert (n_keep < 5).any()  # a proposal was rejected
    for c, (k, v) in zip((cache, c2, dcache), (memory[0], memory[0], memory[1])):
        assert torch.equal(c["stages"][0]["b4"]["k_img"], k) and torch.equal(c["stages"][0]["b4"]["v_img"], v)


# -- refusals -----------------------------------------------------------------------


def test_slots_prefix_cache_and_chunked_prefill_are_refused(model):
    """The reference's refusals, in its words: slot serving (so the
    scheduler), the prefix cache and chunked prefill."""
    _, tcfg, _, tp = model
    eng = Engine(tcfg, tp, max_seq=32, device="cpu")
    slots = "slot-batched serving requires a tokens-input, non-VLM model"
    with pytest.raises(ValueError, match=slots):
        eng.init_slots(2)
    with pytest.raises(ValueError, match=slots):
        Scheduler(eng, n_slots=2).run()
    with pytest.raises(ValueError, match="prefix_cache requires a tokens-input, non-VLM, non-MoE model"):
        Engine(tcfg, tp, max_seq=32, device="cpu", prefix_cache=PrefixCache())
    assert not eng.supports_chunked_prefill
    with pytest.raises(ValueError, match=r"chunked prefill is unsupported for this architecture \(ring-buffer/"
                                         r"recurrent/MoE/VLM"):
        eng.begin_admission(np.arange(6), max_new_tokens=2, chunked=True)


def test_serve_cli_refuses_continuous_vlm_and_serves_sequential(capsys):
    with pytest.raises(ValueError, match="slot-batched serving requires a tokens-input, non-VLM model"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2", "--gen", "2"])
    serve.main(["--device", "cpu", "--arch", ARCH, "--sequential", "--requests", "2", "--gen", "4",
                "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "[sequential] 2 requests" in out and "sample:" in out
