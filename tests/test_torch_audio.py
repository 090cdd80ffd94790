"""Port parity: the audio family, musicgen-medium (a decoder over frame
embeddings: no token table, ``embed_fn`` maps each sampled code back to its
embedding), against the JAX package on the reference's reduced config (2
layers, d_model 64, vocab 256, f32; a 128-wide variant where quantization
must bite), and the port's own invariants on it.

Against JAX: rtol = atol = 2e-4 for the logits (the packages sum the same
f32 products in other orders), also the reference's own bound for cached
prefill + decode against the no-cache forward (``tests/test_models.py``);
configs, parameter leaves, packed bytes and greedy codes exactly. Inside
the port, bit for bit: the captured decode step (embeddings in a static
buffer) == the eager step loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer.engine import Engine as JEngine
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.infer import Engine, PrefixCache, Scheduler, SpecConfig
from repro_torch.infer.graphs import DecodeGraph
from repro_torch.kernels import impl_mode, launch_counts, reset_launch_counts
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, reduced
from repro_torch.models.config import ModelConfig
from repro_torch.quant import QuantPolicy, quantize_params
from torch_helpers import jax_tree_to_numpy, quantized_paths

TOL = 2e-4  # also the reference's bound for this arch's cached prefill + decode
ARCH = "musicgen-medium"
WIDE = dict(d_model=128, n_kv_heads=4, d_ff=256)
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head", "stages",
              "rope_theta", "input_kind", "param_dtype", "compute_dtype")
B = 2


def _close(got, want, tol=TOL, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=msg)


def _cfgs(**kw):
    return jreduced(jget_config(ARCH), **kw), reduced(get_config(ARCH), **kw)


def _frames(cfg, s, seed=0, b=B):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _table_fn(cfg, seed=1):
    """The reference tests' embed_fn: a table lookup of the (B, 1) codes."""
    table = np.random.default_rng(seed).standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    return lambda codes: table[np.asarray(codes)[:, 0]][:, None]


# -- the configs ------------------------------------------------------------------


def test_config_has_the_reference_sizes():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    for f in CFG_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.stages == ((("attn",), 48),) and tc.input_kind == "embeddings"
    assert ARCH in ARCH_IDS


@pytest.mark.parametrize("overrides", [{}, dict(n_layers=5), dict(d_model=128, n_kv_heads=4)])
def test_reduced_and_stages_match_the_reference(overrides):
    jr, tr = _cfgs(**overrides)
    for f in CFG_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f


def test_input_kind_is_checked():
    with pytest.raises(ValueError, match="input_kind 'frames'"):
        ModelConfig(name="x", family="audio", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                    input_kind="frames")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for key, sub in tree.items() for p, v in _leaves(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, sub in enumerate(tree) for p, v in _leaves(sub, path + (i,)).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_init_params_have_the_reference_leaves_and_no_embed(model):
    """No ``embed`` table (an embeddings-input model), every other leaf the
    reference's; ``params_from_numpy`` carries such a tree across."""
    jcfg, tcfg, jp, tp = model
    got = _leaves(init_params(tcfg, seed=0, device="cpu"))
    assert got == _leaves(jp) == _leaves(tp)
    assert not any(p[0] == "embed" for p in got)


# -- the model through forward and Engine.generate ----------------------------------


def test_forward_logits_match_jax(model):
    """A 12-frame prefill, 6 decode steps, and the train forward."""
    jcfg, tcfg, jp, tp = model
    x = _frames(tcfg, 18, 3)
    jc = jinit_cache(jcfg, B, 24)
    lg, jc, _ = jforward(jcfg, jp, embeddings=jnp.asarray(x[:, :12]), cache=jc, pos=jnp.int32(0), logits_mode="last")
    want = [np.asarray(lg[:, -1])]
    tc = init_cache(tcfg, B, 24, device="cpu")
    tx = torch.from_numpy(x)
    with torch.no_grad():
        lt, tc = forward(tcfg, tp, embeddings=tx[:, :12], cache=tc, pos=0, logits_mode="last", prefill=True)
        got = [lt[:, -1]]
        for t in range(12, 18):
            lg, jc, _ = jforward(jcfg, jp, embeddings=jnp.asarray(x[:, t : t + 1]), cache=jc, pos=jnp.int32(t),
                                 logits_mode="last")
            want.append(np.asarray(lg[:, -1]))
            lt, tc = forward(tcfg, tp, embeddings=tx[:, t : t + 1], cache=tc, pos=t, logits_mode="last")
            got.append(lt[:, -1])
        full, _ = forward(tcfg, tp, embeddings=tx)
    _close(torch.stack(got), np.stack(want))
    jfull, _, _ = jforward(jcfg, jp, embeddings=jnp.asarray(x))
    _close(full, jfull)
    with pytest.raises(ValueError, match="exactly one of tokens and embeddings"):
        forward(tcfg, tp)


def test_prefill_decode_matches_train_forward(model):
    """The reference's ``test_prefill_decode_matches_train_forward`` for this
    arch in the port (B 2, S 32, 2e-4) on the weights carried across."""
    _, tcfg, _, tp = model
    s = 32
    x = torch.from_numpy(_frames(tcfg, s, 4))
    with torch.no_grad():
        full, _ = forward(tcfg, tp, embeddings=x)
        cache = init_cache(tcfg, B, s, device="cpu")
        lp, cache = forward(tcfg, tp, embeddings=x[:, : s - 1], cache=cache, pos=0, logits_mode="last", prefill=True)
        lp2, _ = forward(tcfg, tp, embeddings=x[:, s - 1 :], cache=cache, pos=s - 1, logits_mode="last")
    _close(lp[:, 0], full[:, s - 2].numpy())
    _close(lp2[:, 0], full[:, s - 1].numpy())


def test_greedy_generate_equals_jax(model):
    """Greedy codes through a table-lookup ``embed_fn`` equal the JAX
    engine's (its step loop), captured and eager; only the generated codes
    come back, ``(B, n_steps)``."""
    jcfg, tcfg, jp, tp = model
    fn = _table_fn(tcfg)
    x = _frames(tcfg, 8, 5, b=3)
    want = JEngine(jcfg, jp, max_seq=32, embed_fn=fn).generate(x, 12).tokens
    eng = Engine(tcfg, tp, max_seq=32, device="cpu", embed_fn=fn)
    for scan in (True, False):
        res = eng.generate(x, 12, scan=scan)
        assert res.tokens.shape == (3, 12) and res.prompt_len == 8 and res.steps == 12
        np.testing.assert_array_equal(res.tokens, want)


def test_sampled_generate_captured_equals_eager(model):
    _, tcfg, _, tp = model
    eng = Engine(tcfg, tp, max_seq=32, device="cpu", embed_fn=_table_fn(tcfg, 2))
    x = torch.from_numpy(_frames(tcfg, 6, 6))
    a = eng.generate(x, 10, temperature=0.9, seed=3)
    b = eng.generate(x, 10, temperature=0.9, seed=3, scan=False)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_the_captured_step_takes_an_embeddings_buffer(model):
    """The decode graph's input buffer is ``(B, 1, d_model)`` in the compute
    dtype; its step equals ``Engine.decode`` bit for bit."""
    _, tcfg, _, tp = model
    eng = Engine(tcfg, tp, max_seq=16, device="cpu")
    x = torch.from_numpy(_frames(tcfg, 5, 7))
    nxt = torch.from_numpy(_frames(tcfg, 1, 8))
    graph = eng._generate_graph(B)
    assert graph.tokens.shape == (B, 1, 64) and graph.tokens.dtype == torch.float32
    eng.prefill(x, graph.cache)
    got = graph(nxt, 5)
    want, _ = eng.decode(nxt, eng.prefill(x, eng._make_cache(B))[1], 5)
    assert torch.equal(got, want)
    assert isinstance(graph, DecodeGraph)


# -- quantized --------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized():
    jcfg, tcfg = _cfgs(**WIDE)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    jq = jquantize_params(jp, JPolicy(q=4, g=64, method="greedy"))
    mine = quantize_params(params_from_numpy(jax_tree_to_numpy(jp), device="cpu"),
                           QuantPolicy(q=4, g=64, method="greedy"), device="cpu")
    return jcfg, tcfg, jq, mine


def test_quantized_leaves_match_the_reference_bytes(quantized):
    """A tree without ``embed`` quantizes to the reference's leaves, bit for bit."""
    _, _, jq, mine = quantized
    assert quantized_paths(mine) == quantized_paths(jq) and "embed" not in mine
    for name in ("wq", "wo"):
        np.testing.assert_array_equal(mine["stages"][0]["b0"]["attn"][name].packed.numpy(),
                                      np.asarray(jq["stages"][0]["b0"]["attn"][name].packed), err_msg=name)
    np.testing.assert_array_equal(mine["lm_head"].scales.float().numpy(), np.asarray(jq["lm_head"].scales, np.float32))


@pytest.mark.parametrize("mode", ["ref", "bcq_mm"])
def test_forward_quantized_matches_jax(quantized, mode):
    """A 12-frame prefill and 4 decode steps on the packed weights, on the
    oracle and through K1/K2's plain versions (no launch on the CPU),
    against the reference's ``qmatmul(impl="ref")`` (2e-4)."""
    jcfg, tcfg, jq, _ = quantized
    tq = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    x = _frames(tcfg, 16, 9)
    jc = jinit_cache(jcfg, B, 20)
    lg, jc, _ = jforward(jcfg, jq, embeddings=jnp.asarray(x[:, :12]), cache=jc, pos=jnp.int32(0), logits_mode="last")
    want = [np.asarray(lg[:, -1])]
    for t in range(12, 16):
        lg, jc, _ = jforward(jcfg, jq, embeddings=jnp.asarray(x[:, t : t + 1]), cache=jc, pos=jnp.int32(t),
                             logits_mode="last")
        want.append(np.asarray(lg[:, -1]))
    reset_launch_counts()
    tx = torch.from_numpy(x)
    with impl_mode(mode), torch.no_grad():
        tc = init_cache(tcfg, B, 20, device="cpu")
        lt, tc = forward(tcfg, tq, embeddings=tx[:, :12], cache=tc, pos=0, logits_mode="last", prefill=True)
        got = [lt[:, -1]]
        for t in range(12, 16):
            lt, tc = forward(tcfg, tq, embeddings=tx[:, t : t + 1], cache=tc, pos=t, logits_mode="last")
            got.append(lt[:, -1])
    _close(torch.stack(got), np.stack(want))
    assert launch_counts()["bcq_mm"] == 0


# -- refusals -----------------------------------------------------------------------


def test_generate_refusals_match_the_reference(model, quantized):
    """``embed_fn`` is needed, ``stop_tokens`` and speculation are refused,
    each in the reference's words."""
    _, tcfg, _, tp = model
    x = _frames(tcfg, 4, 10)
    with pytest.raises(ValueError, match="embedding-input model: pass embed_fn to Engine"):
        Engine(tcfg, tp, max_seq=16, device="cpu").generate(x, 2)
    eng = Engine(tcfg, tp, max_seq=16, device="cpu", embed_fn=_table_fn(tcfg))
    with pytest.raises(ValueError, match="stop_tokens is only supported for tokens-input models"):
        eng.generate(x, 2, stop_tokens=[3])
    _, wcfg, _, mine = quantized
    qeng = Engine(wcfg, mine, max_seq=16, device="cpu", embed_fn=_table_fn(wcfg))
    with pytest.raises(ValueError, match="speculative decoding requires a tokens-input model"):
        qeng.generate(_frames(wcfg, 4, 11), 2, speculate=SpecConfig(2, 2))


def test_slots_prefix_cache_and_chunked_prefill_are_refused(model):
    _, tcfg, _, tp = model
    eng = Engine(tcfg, tp, max_seq=16, device="cpu", embed_fn=_table_fn(tcfg))
    slots = "slot-batched serving requires a tokens-input, non-VLM model"
    with pytest.raises(ValueError, match=slots):
        eng.init_slots(2)
    with pytest.raises(ValueError, match=slots):
        Scheduler(eng, n_slots=2).run()
    with pytest.raises(ValueError, match="prefix_cache requires a tokens-input, non-VLM, non-MoE model"):
        Engine(tcfg, tp, max_seq=16, device="cpu", prefix_cache=PrefixCache())
    assert not eng.supports_chunked_prefill


def test_serve_cli_refuses_an_embeddings_arch(capsys):
    """An embeddings arch is an argparse error, as the reference's launcher
    makes it."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", ARCH, "--sequential"])
    assert "musicgen-medium is a modality-stub arch" in capsys.readouterr().err
