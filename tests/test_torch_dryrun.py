"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's rules and metadata. The reference's compiled numbers cannot serve
as an oracle here (its ``run_cell`` fails inside ``jax.jit(...).lower`` on
this JAX's explicit mesh axes), so the port is held to what of it still
runs, ``input_specs`` and ``_spec_tree_for``, and to torch's own counters:

- every cell of ``cell_list(("single", "multi"))``: the port's
  ``input_specs`` meta equals the reference's; ``SkipCell`` on
  ``long_500k`` for a pure full-attention model;
- per-rank argument bytes equal a sum over the JAX struct tree and its spec
  trees, for a train, a prefill and a decode cell of each family on both
  meshes;
- meta ``init_params`` / ``init_cache`` / ``quantized_structs`` have the
  CPU's shapes and dtypes leaf for leaf;
- on a reduced llama3.2-3b and olmoe-1b-7b the meta trace's FLOPs equal
  ``FlopCounterMode`` on a real CPU run of the same step; the recurrent
  scans' loops extrapolated from 3 steps equal their whole loops;
- a train cell's per-rank temporaries hold each gradient over its own
  leaf's split and the update traced on the rank's shards;
- the TP collectives rule gives 2L + 1 a forward at (data 1, model 2), with
  the bytes ``parallel/ctx.py`` records in a forward on two gloo ranks;
- the CLI writes a cell's JSON with the reference's keys (less the
  roofline's); one full-size cell runs on the CPU.

The reference's dry-run module sets ``XLA_FLAGS`` when imported, so it is
imported inside the tests (after this process's backend started) with the
variable restored; its struct trees are cached per (arch, q).
"""

import dataclasses
import functools
import json
import os

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels.ops import impl_mode
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_axes
from repro_torch.models import init_cache, init_params, reduced
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.parallel.sharding import MeshAxes
from repro_torch.quant import QuantPolicy, quantize_params, quantized_structs
from repro_torch.train.optimizer import adamw_init
from repro_torch.utils import row_tiles

MESHES = ("single", "multi")
CELLS = dryrun.cell_list(MESHES)
META_KEYS = ("arch", "shape", "kind", "tokens_per_step", "training", "quant_q", "accum_steps", "params_total",
             "params_active", "embed_params")
# one architecture a family
FAMILIES = {"dense": "llama3.2-3b", "moe": "olmoe-1b-7b", "vlm": "llama-3.2-vision-90b", "audio": "musicgen-medium",
            "hybrid": "recurrentgemma-9b", "ssm": "xlstm-125m"}
# the reference's run_cell keys, less the roofline's (H100 constants: not ported yet)
RESULT_KEYS = ("arch", "shape", "mesh", "chips", "quant_q", "lower_s", "compile_s", "memory_analysis",
               "cost_analysis_builtin", "trip_aware", "collectives", "collective_bytes", "collective_wire_bytes",
               "model_flops", "bcq_hbm_adjustment", "meta")


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's dry-run module, its struct trees cached per (config, policy)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    if not hasattr(jdry.param_structs, "cache_info"):
        jdry.param_structs = functools.lru_cache(maxsize=None)(jdry.param_structs)
    return jdry


def test_cell_list_equals_reference():
    assert CELLS == _ref().cell_list(MESHES)
    assert len(CELLS) == 108


@pytest.mark.parametrize("arch,shape,mesh,q", CELLS)
def test_input_specs_meta_equals_reference(arch, shape, mesh, q):
    ax = production_axes(multi_pod=mesh == "multi")
    jmeta = _ref().input_specs(arch, shape, q, dp_size=ax.data_size)[4]
    meta = dryrun.input_specs(arch, shape, q, dp_size=ax.data_size)[4]
    assert {k: meta[k] for k in META_KEYS} == {k: jmeta[k] for k in META_KEYS}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "minitron-4b", "llama-3.2-vision-90b"])
def test_long_context_skip(arch):
    with pytest.raises(dryrun.SkipCell):
        dryrun.input_specs(arch, "long_500k", 4)
    with pytest.raises(_ref().SkipCell):
        _ref().input_specs(arch, "long_500k", 4)
    assert dryrun.input_specs("recurrentgemma-9b", "long_500k", 4)[4]["kind"] == "decode"


def _jax_rank_bytes(args, specs, ax) -> int:
    """One rank's bytes of a JAX struct tree under its dense spec tree."""
    specs = _ref()._spec_tree_for(args, specs, ax)
    leaves = jax.tree.leaves(args)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = leaf.size * leaf.dtype.itemsize
        split = 1
        for axis in spec:
            split *= ax.size(axis) if axis is not None else 1
        assert n % split == 0
        total += n // split
    return total


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", MESHES)
def test_argument_bytes_equal_reference_trees(family, shape, mesh):
    arch = FAMILIES[family]
    q = 0 if SHAPES[shape].kind == "train" else 4
    ax = production_axes(multi_pod=mesh == "multi")
    _, jargs, jspec_fn, _, _ = _ref().input_specs(arch, shape, q, dp_size=ax.data_size)
    want = _jax_rank_bytes(jargs, jspec_fn(ax)[0], ax)
    if SHAPES[shape].kind == "decode":
        want -= 4  # the reference's position is an int32 argument; the port's a Python int
    _, args, spec_fn, _, _ = dryrun.input_specs(arch, shape, q, dp_size=ax.data_size)
    parts = dryrun.argument_parts(SHAPES[shape].kind, args, spec_fn(ax)[0], ax)
    assert sum(parts.values()) == want
    assert set(parts) == set(dryrun.ARG_NAMES[SHAPES[shape].kind])


def _structure(tree, path=()):
    """{path: (shape, dtype)} of every tensor of a parameter tree."""
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    if isinstance(tree, QuantizedTensor):
        return {path: (tuple(tree.packed.shape), tree.packed.dtype, tuple(tree.scales.shape), tree.scales.dtype,
                       tree.g, tree.k, tree.o, tree.fmt)}
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        out.update(_structure(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_trees_equal_cpu_trees(arch):
    cfg = reduced(get_config(arch))
    cpu, meta = init_params(cfg, seed=0, device="cpu"), init_params(cfg, device="meta")
    assert _structure(meta) == _structure(cpu)
    assert all(t.device.type == "meta" for t in dryrun._tensors(meta))
    assert _structure(init_cache(cfg, 3, 40, device="meta")) == _structure(init_cache(cfg, 3, 40, device="cpu"))
    for fmt in ("bcq", "ternary", "codebook"):
        policy = QuantPolicy(q=2, g=32, iters=1, fmt=fmt)
        want = _structure(quantize_params(cpu, policy, device="cpu"))
        assert _structure(quantized_structs(meta, policy)) == want


def _real(cfg, kind, args, seq):
    """A real CPU call of the step whose structs are ``args``: parameters
    from seed 0, zeroed caches, seeded tokens and embeddings."""
    gen = torch.Generator().manual_seed(1)

    def leaf(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, t.shape, dtype=torch.int32, generator=gen)
        return torch.randn(t.shape, generator=gen).to(t.dtype)

    params = init_params(cfg, seed=0, device="cpu")
    if kind == "train":
        return params, adamw_init(params), {k: leaf(v) for k, v in args[2].items()}
    cache = init_cache(cfg, 2, seq, device="cpu")
    if kind == "prefill":
        return params, {k: leaf(v) for k, v in args[1].items()}, cache
    return params, cache, {k: leaf(v) for k, v in args[2].items()}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_trace_flops_equal_real_cpu_run(arch, kind):
    """The trace takes the GPU's row tiles (``utils.row_tiles``); the real
    run takes them too, so both run the same products."""
    cfg = reduced(get_config(arch))
    sc = ShapeConfig("cpu", 24, 2, kind)
    step, args, _, _, _ = dryrun.input_specs(cfg, sc, 0, dp_size=1, accum=1)
    run = step if kind != "decode" else (lambda p, c, b: step(p, c, b, sc.seq_len - 1))
    traced = dryrun.trace_step(run, args)
    real = _real(cfg, kind, args, sc.seq_len)
    with FlopCounterMode(display=False) as counter, impl_mode("ref"), row_tiles():
        run(*real)
    assert traced["flops"] == counter.get_total_flops() > 0
    assert traced["bytes"] > 0 and traced["peak_bytes"] > 0


@pytest.mark.parametrize("arch,layers", [("llama3.2-3b", 4), ("recurrentgemma-9b", 8), ("llama-3.2-vision-90b", 10),
                                         ("xlstm-125m", 4), ("olmoe-1b-7b", 3), ("llama4-maverick-400b-a17b", 4)])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_depth_extrapolation_equals_whole_trace(arch, layers, kind):
    """A serve cell's numbers from one and two repeats of each stage equal
    those of a trace of every layer: FLOPs, bytes and the peak."""
    cfg = reduced(get_config(arch), n_layers=layers)
    assert any(r > 1 for _, r in cfg.stages)
    sc = ShapeConfig("cpu", 24, 2, kind)
    part = dryrun.trace_cell(cfg, sc, 4, 2)
    whole = dryrun._trace_at(cfg, sc, 4, 2)
    assert {k: part[k] for k in dryrun._TRACED} == {k: whole[k] for k in dryrun._TRACED}


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("seq", [7, 12])
def test_scan_loops_extrapolated_equal_the_whole_loops(arch, kind, seq, monkeypatch):
    """The plain scans run at 1, 2 and 3 steps and extrapolated give the
    FLOPs and bytes of their whole loops, forward and backward; the peak
    within 15%."""
    cfg = reduced(get_config(arch))
    sc = ShapeConfig("cpu", seq, 2, kind)
    trip = dryrun._trace_at(cfg, sc, 0, 2)
    monkeypatch.setattr(dryrun, "_SCANS", {})
    whole = dryrun._trace_at(cfg, sc, 0, 2)
    for key in ("flops", "bytes", "update_flops", "update_bytes"):
        assert trip[key] == whole[key], key
    assert abs(trip["peak_bytes"] / whole["peak_bytes"] - 1) < 0.15


def test_tracker_counts_bytes_and_live_storage():
    """A tiny step whose bytes and peak are known by hand."""

    def step(x, w):
        y = x @ w  # reads 64 + 32, writes 32 bytes (f32)
        z = y.t()  # a view: nothing
        del y
        return (z * 2).sum()  # reads 32, writes 32; reads 32, writes 4

    args = (torch.empty((2, 8), device="meta"), torch.empty((8, 4), device="meta"))
    out = dryrun.trace_step(step, args)
    assert out["flops"] == 2 * 2 * 8 * 4
    assert out["bytes"] == (64 + 128 + 32) + (32 + 32) + (32 + 4)
    assert out["peak_bytes"] == 32 + 32 + 4  # y (alive through z), z * 2 and its sum
    assert tuple(out["outputs"].shape) == ()


def test_tp_collectives_rule_matches_ctx_on_two_ranks():
    """The rule's TP collectives at (data 1, model 2) against the counts and
    result bytes ``parallel/ctx.py`` records in one prefill forward and one
    decode step of two gloo ranks."""
    import torch_tp_ranks as R

    from repro_torch.launch._ranks import run_ranks

    batch, seq = 2, 6
    ranks = run_ranks(R.collective_sizes, 2, (batch, seq), device="cpu", timeout=300)
    cfg = R.config()
    ax = MeshAxes(("data",), "data", "model", (("data", 1), ("model", 2)))
    for kind, s in (("prefill", seq), ("decode", 1)):
        rule = dryrun.collectives_of(cfg, ax, kind, batch, s, 1, 1)
        assert rule["all-reduce"]["count"] + rule["all-gather"]["count"] == 2 * cfg.n_layers + 1
        for counts, nbytes in (r[kind] for r in ranks):
            assert counts == {"all_reduce": rule["all-reduce"]["count"], "all_gather": 1, "broadcast": 0}
            assert nbytes["all_reduce"] == rule["all-reduce"]["bytes"]
            assert nbytes["all_gather"] == rule["all-gather"]["bytes"]
        assert rule["all-reduce"]["wire_bytes"] == rule["all-reduce"]["bytes"]  # 2(n-1)/n = 1 at n = 2


def test_train_collectives_rule():
    """FSDP, TP and pod collectives of a train cell by the stated rules, on
    llama3.2-3b's multi-pod mesh: every FSDP-sharded leaf gathered twice a
    microbatch in the stacked layers, once outside, scattered once; every
    leaf's shard all-reduced across the pods once a step."""
    cfg = get_config("llama3.2-3b")
    ax = production_axes(multi_pod=True)
    _, args, spec_fn, _, meta = dryrun.input_specs("llama3.2-3b", "train_4k", 0, dp_size=ax.data_size)
    A = meta["accum_steps"]
    coll = dryrun.collectives_of(cfg, ax, "train", 1, 4096, 4096, A, args[0], spec_fn(ax)[0][0])
    L = cfg.n_layers
    n_leaves = len(list(dryrun._tensors(args[0])))
    assert coll["all-reduce"]["count"] == (2 * L + 2 * L + 2 * L + 1) * A + n_leaves + 3 * A  # 3 norms whole over data
    assert coll["reduce-scatter"]["count"] == (n_leaves - 3) * A
    assert coll["all-gather"]["count"] == (2 * 7 * 1 + 2) * A + A  # 7 stacked weights twice, embed and head, logits


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b", "xlstm-125m"])
@pytest.mark.parametrize("data,model,accum", [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2)])
def test_train_rank_peak_splits_gradients_by_their_leaf(arch, data, model, accum):
    """A train cell's temporaries per rank: the gradients live when the
    update starts are each leaf's bytes over its own spec's split (the
    params' per-rank bytes: same shapes, dtypes and specs), the update's
    temporaries come from a trace on the rank's shards, the f32 gradient sum
    of several microbatches is 4 bytes a parameter over its leaf's split,
    and on a 1 x 1 mesh ``temp_size`` is the whole trace's peak and the
    rank's update the traced one."""
    cfg = reduced(get_config(arch))
    ax = MeshAxes(("data",), "data", "model", (("data", data), ("model", model)))
    sc = ShapeConfig("t", 16, 8, "train")
    res = dryrun.run_cell(cfg, sc, ax, 0, verbose=False, accum=accum)
    rank, params = res["rank_peak"], res["argument_parts"]["params"]
    assert rank["gradients_at_update"] == params
    assert rank["at_update"] - params < 64  # the step's metrics beside the gradients
    assert rank["update_temporaries"] == res["rank_update"]["peak_bytes"] > 0
    assert all(t.dtype == torch.float32 for t in dryrun._tensors(dryrun.param_structs(cfg, None)))
    assert rank.get("gradient_sum", 0) == (params if accum > 1 else 0)  # f32 params: 4 bytes a parameter
    want = max(rank["forward_backward"], rank["at_update"] + rank["update_temporaries"]) + rank.get("gradient_sum", 0)
    assert res["memory_analysis"]["temp_size"] == want
    if data * model == 1:
        assert res["memory_analysis"]["temp_size"] == res["trace"]["peak_bytes"]
        assert (res["rank_update"]["flops"], res["rank_update"]["bytes"]) == (
            res["trace"]["update_flops"], res["trace"]["update_bytes"])
    else:
        assert res["memory_analysis"]["temp_size"] < res["trace"]["peak_bytes"]


def test_cli_writes_one_cell_with_reference_keys(tmp_path, capsys):
    argv = ["--arch", "xlstm-125m", "--shape", "decode_32k", "--mesh", "single", "--out-dir", str(tmp_path)]
    dryrun.main(argv)
    path = tmp_path / "xlstm-125m__decode_32k__single__q4.json"
    res = json.loads(path.read_text())
    assert set(RESULT_KEYS) <= set(res) and "roofline" not in res
    assert set(res["memory_analysis"]) == {"argument_size", "output_size", "temp_size", "generated_code_size"}
    assert set(res["cost_analysis_builtin"]) == {"flops", "bytes"}
    assert res["chips"] == 256 and res["meta"]["kind"] == "decode"
    assert "done: 1 ok, 0 skipped, 0 failed" in capsys.readouterr().out
    dryrun.main(argv)  # resumable: an existing cell is skipped
    assert "done: 0 ok, 1 skipped, 0 failed" in capsys.readouterr().out


def test_full_size_decode_cell_on_cpu():
    res = dryrun.run_cell("llama3.2-3b", "decode_32k", "single", 4, verbose=False)
    cfg = get_config("llama3.2-3b")
    m, t = res["memory_analysis"], res["trace"]
    assert res["chips"] == 256 and t["rank_rows"] == 128 // 16 and t["model_size"] == 16
    assert m["argument_size"] == sum(res["argument_parts"].values())
    # the cache: 28 layers of K and V, 8 rank rows, 32768 positions, 8 heads, Dh 128 / 16, bf16
    assert res["argument_parts"]["cache"] == 28 * 2 * 8 * 32768 * 8 * 8 * 2
    assert m["temp_size"] > 0 and res["cost_analysis_builtin"]["flops"] > 0
    assert res["cost_analysis_builtin"]["flops"] == t["flops"] / 16
    assert res["collectives"]["all-reduce"]["count"] == 2 * cfg.n_layers
    assert res["collectives"]["all-gather"]["count"] == 1
    assert res["model_flops"] == 2.0 * res["meta"]["params_active"] * 128
    assert res["bcq_hbm_adjustment"] > 0


ONE = MeshAxes(("data",), "data", "model", (("data", 1), ("model", 1)))


def _bf16_llama():
    return reduced(get_config("llama3.2-3b"), d_model=128, d_ff=256, param_dtype="bfloat16",
                   compute_dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _bcq_params():
    return quantize_params(init_params(_bf16_llama(), seed=0, device="cpu"), QuantPolicy(q=4, g=128, iters=1),
                           device="cpu")


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("batch", [4, 6])
def test_decode_arguments_equal_an_engines_resident_bytes(kv, batch):
    """What the smoke checks in phase 10, on a reduced model on the CPU: the
    dry run's params (quantized, bcq q = 4) and cache bytes equal those of
    an ``Engine``'s params and its decode graph's cache."""
    from repro_torch.infer import Engine
    from repro_torch.quant import quantized_bytes
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(_bf16_llama(), kv_cache_dtype=kv)
    engine = Engine(cfg, _bcq_params(), max_seq=64, fuse=False, device="cpu")
    graph = engine._generate_graph(batch)
    cache_bytes = sum(leaf.nbytes for leaf in tree_leaves(graph.cache))
    parts = dryrun.run_cell(cfg, ShapeConfig("d", 64, batch, "decode"), ONE, 4, verbose=False)["argument_parts"]
    assert (parts["params"], parts["cache"]) == (quantized_bytes(engine.params), cache_bytes)


def test_train_arguments_equal_the_clis_tensors():
    """What the smoke checks in phase 17, on the reduced model: the dry run's
    params, AdamW state and batch bytes equal the CLI's tensors after a
    step, and its predicted peak is positive beside them."""
    from repro_torch.data import MarkovCorpus, batch_iterator
    from repro_torch.launch.train import main as train_main
    from repro_torch.utils import tree_leaves

    cfg, params, opt, _ = train_main(["--steps", "1", "--batch", "4", "--seq", "16", "--device", "cpu",
                                      "--log-every", "1"], log=lambda _: None)
    batch = next(batch_iterator(MarkovCorpus(cfg.vocab, seed=0), batch=4, seq_len=16))
    nbytes = lambda leaves: sum(t.numel() * t.element_size() for t in leaves)  # noqa: E731
    resident = {"params": nbytes(tree_leaves(params)), "opt": nbytes([opt.step, *tree_leaves(opt.m),
                                                                       *tree_leaves(opt.v)]),
                "batch": nbytes([torch.from_numpy(v) for v in batch.values()])}
    res = dryrun.run_cell(cfg, ShapeConfig("t", 16, 4, "train"), ONE, 0, verbose=False, accum=1)
    assert res["argument_parts"] == resident
    assert res["memory_analysis"]["temp_size"] > resident["params"]  # the gradients at least
