"""Port parity: the training runtime (``repro_torch/train``, the loader of
``data/synthetic.py``, ``models.forward``'s training options) against the
JAX package's, on reduced f32 configs, and the port's own invariants.

Tolerances:
- the loader and the embeddings table: bit for bit (both numpy);
- ``adamw_update`` (parameters, ``m``, ``v``, grad norm), ``cosine_lr`` and
  ``cross_entropy``: f32 rounding, rtol 1e-6 / atol 1e-7 (the packages
  round the same f32 operations; ``m / c1`` may be fused differently);
- the loss: rtol 1e-6; every gradient leaf: max|Δ| within 2e-5 of that
  leaf's max|g_jax| (``GRAD_TOL``; the packages sum the same f32 products
  in other orders through the layers and the backward; 1e-6–5e-6 seen);
- one ``make_train_step`` step: post-update parameters within the
  reference's own rtol 2e-3, atol 2e-4 (``tests/test_train.py:69-80``:
  AdamW divides by sqrt(v) + eps, which magnifies ulp-level gradient
  differences on near-zero second moments), the loss rtol 1e-6;
- inside the port, remat on == off and the train step's bits are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import MarkovCorpus as JCorpus
from repro.data import batch_iterator as jbatch_iterator
from repro.data.synthetic import _embed_table as j_embed_table
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.train import adamw_init as jadamw_init
from repro.train import adamw_update as jadamw_update
from repro.train import cosine_lr as jcosine_lr
from repro.train import cross_entropy as jcross_entropy
from repro.train import loss_fn as jloss_fn
from repro.train import make_prefill_step as jmake_prefill_step
from repro.train import make_serve_step as jmake_serve_step
from repro.train import make_train_step as jmake_train_step
from repro.models import init_cache as jinit_cache
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus, batch_iterator
from repro_torch.data.synthetic import _embed_table
from repro_torch.infer import Engine
from repro_torch.kernels._common import forward_only
from repro_torch.models import forward, init_cache, init_params, opt_state_from_numpy, params_from_numpy, reduced
from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes
from repro_torch.train import (
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_lr,
    cross_entropy,
    loss_and_grads,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.train.checkpoint import leaf_paths
from repro_torch.utils import tree_leaves, tree_map
from torch_helpers import jax_tree_to_numpy

KEY = jax.random.PRNGKey(0)
GRAD_TOL = 2e-5
FAMILIES = ("llama3.2-3b", "recurrentgemma-9b", "xlstm-125m", "olmoe-1b-7b", "musicgen-medium", "llama-3.2-vision-90b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _models(arch, **kw):
    jcfg, tcfg = jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)
    jp = jinit_params(KEY, jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _batch(cfg, batch=2, seq=24, seed=0):
    emb = cfg.d_model if cfg.input_kind == "embeddings" else None
    b = next(batch_iterator(MarkovCorpus(cfg.vocab, seed=0), batch=batch, seq_len=seq, seed=seed, embed_dim=emb))
    if cfg.family == "vlm":
        b["image_emb"] = np.random.default_rng(5).standard_normal((batch, cfg.n_image_tokens, cfg.d_model)).astype(
            np.float32)
    return b


def _leaf_errors(got, want):
    """{key: max|Δ| / max|want|} over matching leaves of two trees."""
    want = dict(leaf_paths(want))
    out = {}
    for key, g in leaf_paths(got):
        w = np.asarray(want[key], np.float32)
        out[key] = float(np.max(np.abs(_np(g) - w))) / max(float(np.max(np.abs(w))), 1e-30)
    return out


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(batch=8, seq_len=16, seed=1), dict(batch=8, seq_len=16, seed=1, process_index=1,
                                                                          process_count=2),
                                dict(batch=4, seq_len=8, embed_dim=32), dict(batch=2, seq_len=5, seed=3, embed_dim=7)],
                         ids=["tokens", "host-shard", "embeddings", "embeddings-odd"])
def test_batch_iterator_equals_the_reference_bit_for_bit(kw):
    jit, tit = jbatch_iterator(JCorpus(64, seed=0), **kw), batch_iterator(MarkovCorpus(64, seed=0), **kw)
    for _ in range(3):
        want, got = next(jit), next(tit)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_embed_table_equals_the_reference_bit_for_bit():
    for vocab, dim in ((64, 32), (1000, 3)):
        want, got = j_embed_table(vocab, dim), _embed_table(vocab, dim)
        assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


# -- optimizer, schedule, loss ---------------------------------------------------


def _opt_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 4)}}
    mk = lambda scale: {"a": rng.standard_normal(shapes["a"]).astype(np.float32) * scale,  # noqa: E731
                        "b": {"c": rng.standard_normal(3).astype(np.float32) * scale,
                              "d": rng.standard_normal((2, 4, 4)).astype(np.float32) * scale}}
    p, g, m, v = mk(1.0), mk(3.0), mk(0.1), mk(0.1)
    v = jax.tree.map(np.abs, v)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return {k: jax.tree.map(lambda x: jnp.asarray(x, jdt), t) for k, t in (("p", p), ("g", g))} | {"m": m, "v": v}


@pytest.mark.parametrize("clip", [0.0, 1.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, clip):
    x = _opt_inputs(dtype)
    jst = jadamw_init(x["p"])
    jst = dataclasses.replace(jst, step=jnp.int32(4), m=jax.tree.map(jnp.asarray, x["m"]),
                              v=jax.tree.map(jnp.asarray, x["v"]))
    jp, jst2, jn = jadamw_update(x["g"], jst, x["p"], lr=jnp.float32(3e-3), grad_clip=clip)
    tp, tg = (params_from_numpy(jax_tree_to_numpy(x[k]), device="cpu") for k in ("p", "g"))
    tst = AdamWState(step=torch.tensor(4, dtype=torch.int32), m=params_from_numpy(x["m"], device="cpu"),
                     v=params_from_numpy(x["v"], device="cpu"))
    st, p = AdamWState(step=tst.step.clone(), m=tree_map(torch.clone, tst.m), v=tree_map(torch.clone, tst.v)), \
        tree_map(torch.clone, tp)
    gp, gst, gn = adamw_update(tg, st, p, lr=3e-3, grad_clip=clip)
    assert int(gst.step) == int(jst2.step) == 5
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    for got, want, name in ((gp, jp, "params"), (gst.m, jst2.m, "m"), (gst.v, jst2.v, "v")):
        for (k, a), (_, b) in zip(leaf_paths(got), leaf_paths(jax_tree_to_numpy(want))):
            assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype), (name, k)
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), rtol=1e-6, atol=1e-7, err_msg=name + k)
    assert gp is p and gst is st and tree_leaves(gp)[0] is tree_leaves(p)[0]


def test_adamw_in_place_pieces_equal_the_whole_leaf(monkeypatch):
    """``adamw_update`` updates a large leaf in pieces of whole rows (one row
    of a stacked leaf, several of a narrow one): pieces of 16 elements give
    the same bits as the default, which takes each of these leaves whole."""
    from repro_torch.train import optimizer as O

    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((4, 5, 6), generator=gen).to(torch.bfloat16), "b": torch.randn(3, generator=gen),
         "e": torch.randn((11, 3), generator=gen), "s": torch.randn((), generator=gen)}
    g = tree_map(lambda t: torch.randn(t.shape, generator=gen).to(t.dtype), p)
    st = adamw_init(p)
    st.m, st.v = tree_map(lambda t: torch.rand(t.shape, generator=gen), st.m), tree_map(lambda t: torch.rand(
        t.shape, generator=gen), st.v)
    fresh = lambda: (tree_map(torch.clone, p), AdamWState(step=st.step.clone(), m=tree_map(torch.clone, st.m),  # noqa: E731
                                                         v=tree_map(torch.clone, st.v)))
    p0, st0 = fresh()
    want_p, want_st, _ = adamw_update(g, st0, p0, lr=1e-2)
    monkeypatch.setattr(O, "SLICE_ELEMS", 16)
    p1, st1 = fresh()
    got_p, got_st, _ = adamw_update(g, st1, p1, lr=1e-2)
    for a, b in zip(tree_leaves((got_p, got_st.m, got_st.v)), tree_leaves((want_p, want_st.m, want_st.v))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(got_p), tree_leaves(p)))


def test_adamw_init_moments_are_f32_beside_the_params():
    p = {"w": torch.ones((3, 2), dtype=torch.bfloat16), "b": (torch.zeros(4),)}
    st = adamw_init(p)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for t in tree_leaves(st.m) + tree_leaves(st.v):
        assert t.dtype == torch.float32 and not t.any()
    assert st.m["w"].shape == (3, 2) and st.m["w"] is not st.v["w"]


def test_cosine_lr_matches_jax():
    for s in (0, 3, 10, 11, 55, 100, 140):
        want = float(jcosine_lr(jnp.int32(s), peak=1e-3, warmup=10, total=100))
        got = float(cosine_lr(torch.tensor(s, dtype=torch.int32), peak=1e-3, warmup=10, total=100))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_cross_entropy_with_masking_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, (3, 7)).astype(np.int32)
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(float(cross_entropy(_t(logits), _t(labels))), want, rtol=1e-6)
    all_masked = -np.ones((3, 7), np.int32)
    assert float(cross_entropy(_t(logits), _t(all_masked))) == float(jcross_entropy(logits, all_masked)) == 0.0


# -- loss and gradients against jax.value_and_grad ---------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax(arch):
    """The reference's ``loss_fn`` under ``jax.value_and_grad`` against the
    port's :func:`loss_and_grads` on the same weights and batch: the loss,
    the MoE load-balance term and every gradient leaf."""
    jcfg, tcfg, jp, tp = _models(arch)
    b = _batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, bb: jloss_fn(jcfg, p, bb), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tm, tg = loss_and_grads(tcfg, tp, {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["moe_aux"]), float(jm["moe_aux"]), rtol=1e-6, atol=1e-7)
    if jcfg.n_experts:
        assert float(jm["moe_aux"]) > 0  # the aux term is exercised
    errs = _leaf_errors(tg, jax_tree_to_numpy(jg))
    assert len(errs) == len(jax.tree.leaves(jg))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert not any(t.requires_grad for t in tree_leaves(tp))  # the caller's leaves are untouched


def test_loss_fn_total_adds_the_weighted_aux():
    _, tcfg, _, tp = _models("olmoe-1b-7b")
    b = {k: _t(v) for k, v in _batch(tcfg).items()}
    total, m = loss_fn(tcfg, tp, b)
    assert float(total) == float(m["loss"] + 0.01 * m["moe_aux"])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b", "xlstm-125m"])
def test_remat_on_equals_off_bit_for_bit(arch):
    _, tcfg, _, tp = _models(arch)
    b = {k: _t(v) for k, v in _batch(tcfg).items()}
    (m1, g1), (m0, g0) = (loss_and_grads(tcfg, tp, b, remat=r) for r in (True, False))
    assert float(m1["loss"]) == float(m0["loss"]) and float(m1["moe_aux"]) == float(m0["moe_aux"])
    for a, c in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, c)


def test_forward_training_options_keep_the_default_return():
    _, tcfg, _, tp = _models("olmoe-1b-7b")
    toks = _t(_batch(tcfg)["tokens"])
    with torch.no_grad():
        out = forward(tcfg, tp, tokens=toks)
        out_aux = forward(tcfg, tp, tokens=toks, with_aux=True, remat=True)
    assert len(out) == 2 and len(out_aux) == 3 and torch.equal(out[0], out_aux[0])
    assert out_aux[2].dtype == torch.float32 and float(out_aux[2]) > 0
    with pytest.raises(ValueError, match="remat"):
        forward(tcfg, tp, tokens=toks, cache=init_cache(tcfg, 2, 32, device="cpu"), pos=0, remat=True)


# -- the train step ----------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_jax(accum):
    jcfg, tcfg, jp, tp = _models("llama3.2-3b", d_model=32, n_layers=2, vocab=64)
    toks = jax.random.randint(KEY, (8, 16), 0, jcfg.vocab)
    labels = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, jcfg.vocab)
    jb = {"tokens": toks, "labels": labels}
    jp1, jo1, jm = jax.jit(jmake_train_step(jcfg, lr=1e-2, accum_steps=accum))(jp, jadamw_init(jp), jb)
    tb = {k: _t(v) for k, v in jb.items()}
    tp1, to1, tm = make_train_step(tcfg, lr=1e-2, accum_steps=accum)(tp, adamw_init(tp), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(to1.step) == int(jo1.step) == 1
    for got, want in ((tp1, jp1), (to1.m, jo1.m), (to1.v, jo1.v)):
        want = dict(leaf_paths(jax_tree_to_numpy(want)))
        for key, a in leaf_paths(got):
            np.testing.assert_allclose(_np(a), want[key], rtol=2e-3, atol=2e-4, err_msg=key)


def test_train_step_accumulation_equivalence_in_the_port():
    """The counterpart of ``test_grad_accumulation_equivalence``: 4
    microbatches give the update of one full batch within the reference's
    bound."""
    _, tcfg, _, tp = _models("llama3.2-3b", d_model=32, n_layers=2, vocab=64)
    b = {k: _t(v) for k, v in _batch(tcfg, batch=8, seq=16).items()}
    outs = [make_train_step(tcfg, lr=1e-2, accum_steps=a)(tree_map(torch.clone, tp), adamw_init(tp), b)
            for a in (1, 4)]
    np.testing.assert_allclose(float(outs[0][2]["loss"]), float(outs[1][2]["loss"]), rtol=1e-5)
    for a, c in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        np.testing.assert_allclose(_np(a), _np(c), rtol=2e-3, atol=2e-4)


def test_train_step_writes_in_place_and_repeats_its_bits():
    _, tcfg, _, tp = _models("llama3.2-3b", d_model=32, n_layers=2, vocab=64)
    b = {k: _t(v) for k, v in _batch(tcfg).items()}
    step = make_train_step(tcfg, lr=1e-3)
    runs = []
    for _ in range(2):
        p, o = tree_map(torch.clone, tp), adamw_init(tp)
        p1, o1, m = step(p, o, b)
        assert p1 is p and o1 is o and not any(t.requires_grad for t in tree_leaves(p1))
        runs.append((p1, o1, m))
    assert float(runs[0][2]["loss"]) == float(runs[1][2]["loss"])
    for a, c in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, c)


def test_training_learns():
    """The counterpart of ``tests/test_train.py::test_training_learns``."""
    cfg = reduced(get_config("llama3.2-3b"), d_model=64, n_layers=2, vocab=256)
    params = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=2e-3)
    it = batch_iterator(MarkovCorpus(cfg.vocab, seed=0), batch=8, seq_len=48)
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, {k: _t(v) for k, v in next(it).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_full_workflow_train_quantize_serve():
    """The counterpart of ``tests/test_system.py``'s workflow: train,
    quantize to BCQ, serve dense and quantized; greedy decode repeats."""
    cfg = reduced(get_config("llama3.2-3b"), d_model=128, n_layers=2, vocab=512)
    params = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=2e-3)
    corpus = MarkovCorpus(cfg.vocab, seed=0)
    it = batch_iterator(corpus, batch=8, seq_len=48)
    first = None
    for _ in range(25):
        params, opt, m = step(params, opt, {k: _t(v) for k, v in next(it).items()})
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first
    qp = quantize_params(params, QuantPolicy(q=4, g=64, iters=4), device="cpu")
    assert quantized_bytes(qp) < 0.45 * quantized_bytes(params)
    prompt = corpus.sample(2, 8, seed=42)[:, :8].astype(np.int32)
    eng_dense = Engine(cfg, params, max_seq=64, device="cpu")
    eng_quant = Engine(cfg, qp, max_seq=64, device="cpu")
    rd, rq = eng_dense.generate(prompt, 12), eng_quant.generate(prompt, 12)
    assert rd.tokens.shape == rq.tokens.shape == (2, 20)
    np.testing.assert_array_equal(rd.tokens, eng_dense.generate(prompt, 12).tokens)
    # the trained model has learned the chain: its held-out NLL is below the untrained one's
    held = corpus.sample(4, 32, seed=777)
    nll = lambda p: float(cross_entropy(forward(cfg, p, tokens=_t(held[:, :-1]))[0], _t(held[:, 1:])))  # noqa: E731
    with torch.no_grad():
        assert nll(params) < nll(init_params(cfg, seed=0, device="cpu")) - 0.3


# -- prefill / serve steps, the state carried across, the guard ----------------------


def test_prefill_and_serve_steps_match_jax():
    jcfg, tcfg, jp, tp = _models("llama3.2-3b")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    jl, jc = jmake_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)}, jinit_cache(jcfg, 2, 16))
    jl2, _ = jmake_serve_step(jcfg)(jp, jc, {"tokens": jnp.asarray(toks[:, -1:])}, jnp.int32(8))
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(tp, {"tokens": _t(toks)}, init_cache(tcfg, 2, 16, device="cpu"))
        tl2, _ = make_serve_step(tcfg)(tp, tc, {"tokens": _t(toks[:, -1:])}, 8)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(tl2), np.asarray(jl2), rtol=2e-4, atol=2e-4)


def test_opt_state_from_numpy_carries_the_reference_state():
    jcfg, tcfg, jp, tp = _models("llama3.2-3b", d_model=32, n_layers=2, vocab=64)
    b = {"tokens": jnp.asarray(np.arange(32).reshape(2, 16) % 64), "labels": jnp.asarray(np.ones((2, 16), np.int32))}
    _, jo, _ = jax.jit(jmake_train_step(jcfg, lr=1e-2))(jp, jadamw_init(jp), b)
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    assert isinstance(to, AdamWState) and to.step.dtype == torch.int32 and int(to.step) == 1
    for got, want in ((to.m, jo.m), (to.v, jo.v)):
        for (k, a), (_, w) in zip(leaf_paths(got), leaf_paths(jax_tree_to_numpy(want))):
            assert a.dtype == torch.float32 and a.numpy().tobytes() == np.asarray(w).tobytes(), k


def test_forward_only_guard():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="my_kernel: the hand-written kernel is forward-only"):
        forward_only("my_kernel", None, torch.ones(2), x)
    with torch.no_grad():
        forward_only("my_kernel", x)
    forward_only("my_kernel", x.detach(), None)
