"""The port's tensor-parallel placement (``repro_torch.parallel``) against the
JAX package's: no process group is needed, since a rank's slices are cut
from the whole tree by ``shard_model`` with a ``TPMesh`` naming the rank.

- **placement**: for tp ∈ {2, 4}, fused and unfused, and every format, the
  port's rank-r slice of every leaf (planes, scales, codebook tables, dense
  weights, replicated leaves) equals, bit for bit, the reference's
  ``shard_model(...)`` shard on device r, and each quantized leaf's static
  ``(k, o)`` is its shard's;
- **permutation**: ``_interleave_perm`` equals the reference's;
- **cache split**: a rank's ``init_cache`` of the local config has the
  shapes of the reference's ``cache_specs(layout="heads")`` shards;
- **refusals**: the same exception type and the same message, naming the
  same leaf, as the reference's (``test_tp_serve.py``,
  ``test_tp_placement.py``).

Weights are the reference test's reduced llama3.2-3b (``d_model=128,
n_kv_heads=4, d_ff=256``, g = 32), quantized by the JAX package and carried
across bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.qtensor import QuantizedTensor as JQT
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.models.fuse import fuse_decode_projections as jfuse
from repro.parallel import cache_specs as jcache_specs
from repro.parallel import decode_tp_axes as jdecode_tp_axes
from repro.parallel import tp as jtp
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.models import fuse_decode_projections, init_cache, params_from_numpy, reduced
from repro_torch.parallel import tp
from torch_helpers import jax_tree_to_numpy

pytestmark = pytest.mark.needs_multidevice

SIZES = dict(d_model=128, n_kv_heads=4, d_ff=256)
Q_GROUP = 32
# (format, q): the reference test's q = 3 for the added formats, bcq at 4
FORMATS = [("dense", 0), ("bcq", 4), ("uniform", 3), ("ternary", 3), ("codebook", 3)]


def _cfgs():
    return jreduced(jget_config("llama3.2-3b"), **SIZES), reduced(get_config("llama3.2-3b"), **SIZES)


@functools.lru_cache(maxsize=None)
def _jax_params(fmt: str, q: int):
    jcfg, _ = _cfgs()
    params = jinit_params(jax.random.PRNGKey(0), jcfg)
    if q:
        params = jquantize_params(params, JPolicy(q=q, g=Q_GROUP, iters=2, fmt=fmt))
    return params


def _port_params(fmt, q, fused):
    _, cfg = _cfgs()
    params = params_from_numpy(jax_tree_to_numpy(_jax_params(fmt, q)), device="cpu")
    return fuse_decode_projections(cfg, params) if fused else params


def _mesh(rank, n):
    return tp.TPMesh(rank=rank, size=n, backend="gloo", device=torch.device("cpu"))


def _shard_on(arr, device):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _walk(jtree, ttree, path=()):
    """Pairs (path, JAX leaf, port leaf) of two trees of the same keys."""
    if isinstance(jtree, JQT):
        yield path, jtree, ttree
    elif isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            yield from _walk(jtree[k], ttree[k], path + (k,))
    elif isinstance(jtree, (tuple, list)):
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _walk(a, b, path + (i,))
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt,q", FORMATS, ids=[f for f, _ in FORMATS])
def test_rank_slices_equal_reference_shards(fmt, q, fused, n):
    jcfg, cfg = _cfgs()
    jparams = _jax_params(fmt, q)
    if fused:
        jparams = jfuse(jcfg, jparams)
    mesh = jtp.make_tp_mesh(n)
    placed, _ = jtp.shard_model(jcfg, jparams, mesh)
    devices = list(mesh.devices.flat)
    whole = _port_params(fmt, q, fused)
    for rank in range(n):
        local, tpc = tp.shard_model(cfg, whole, _mesh(rank, n))
        assert tpc.cfg_local.n_heads * n == cfg.n_heads and tpc.cfg_local.n_kv_heads * n == cfg.n_kv_heads
        seen = 0
        for path, jleaf, tleaf in _walk(placed, local):
            where = f"{fmt} tp={n} rank {rank} {'/'.join(map(str, path))}"
            if isinstance(jleaf, JQT):
                assert isinstance(tleaf, QuantizedTensor) and tleaf.fmt == jleaf.fmt, where
                for plane in ("packed", "scales"):
                    ref = _shard_on(getattr(jleaf, plane), devices[rank])
                    np.testing.assert_array_equal(_bits(getattr(tleaf, plane)), _np_bits(ref), err_msg=where)
                assert (tleaf.k, tleaf.o) == (tleaf.packed.shape[-2] * 8, tleaf.packed.shape[-1]), where
                assert tleaf.g == jleaf.g, where
            else:
                np.testing.assert_array_equal(_bits(tleaf), _np_bits(_shard_on(jleaf, devices[rank])),
                                              err_msg=where)
            seen += 1
        assert seen == len(jax.tree.leaves(placed, is_leaf=lambda x: isinstance(x, JQT)))


@pytest.mark.parametrize("out_dims,n", [((12, 8, 8), 4), ((128, 32, 32), 2), ((3072, 1024, 1024), 2),
                                        ((8192, 8192), 4), ((6, 6), 3)])
def test_interleave_perm_equals_reference(out_dims, n):
    np.testing.assert_array_equal(tp._interleave_perm(out_dims, n), jtp._interleave_perm(out_dims, n))


def _jax_axis(spec, ndim):
    """The (negative) axis a PartitionSpec puts on ``model``, or None."""
    axes = [i - ndim for i, a in enumerate(tuple(spec)) if a == "model"]
    return axes[0] if axes else None


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("fmt,q", FORMATS, ids=[f for f, _ in FORMATS])
def test_param_split_axes_equal_reference(fmt, q, fused, n):
    """``tp_param_specs`` splits every leaf (each plane of a quantized one)
    along the axis the reference's ``PartitionSpec`` puts on ``model``,
    and holds whole what the reference replicates."""
    jcfg, cfg = _cfgs()
    jparams = _jax_params(fmt, q)
    if fused:
        jparams = jfuse(jcfg, jparams)
    jspecs = jtp.tp_param_specs(jcfg, jparams, jdecode_tp_axes(n))
    specs = tp.tp_param_specs(cfg, _port_params(fmt, q, fused), n)
    split = 0
    for path, jleaf, _ in _walk(jparams, _port_params(fmt, q, fused)):
        jspec, spec = _at(jspecs, path), _at(specs, path)
        if isinstance(jleaf, JQT):
            want = (_jax_axis(jspec.packed, jleaf.packed.ndim), _jax_axis(jspec.scales, jleaf.scales.ndim))
        else:
            want = _jax_axis(jspec, jleaf.ndim)
        assert spec == want, (path, spec, want)
        split += want != (None, None) and want is not None
    assert split  # the column- and row-parallel leaves split


@pytest.mark.parametrize("arch,extra", [("llama3.2-3b", {}), ("llama3.2-3b", {"kv_cache_dtype": "int8"}),
                                        ("llama-3.2-vision-90b", {})])
@pytest.mark.parametrize("n", [2, 4])
def test_cache_split_axes_equal_reference(arch, extra, n):
    """A rank's cache, ``init_cache`` of ``TPContext.cfg_local``, has the
    shape of the reference's ``layout="heads"`` shard of every leaf."""
    sizes = dict(SIZES, **extra) if arch == "llama3.2-3b" else dict(extra, n_heads=4, n_kv_heads=4)
    jcfg = jreduced(jget_config(arch), **sizes)
    cfg = reduced(get_config(arch), **sizes)
    jspecs = jcache_specs(jcfg, jdecode_tp_axes(n), 1, layout="heads")
    cache = init_cache(cfg, 1, 16, device="cpu")
    local = init_cache(tp.TPContext(cfg, _mesh(0, n)).cfg_local, 1, 16, device="cpu")
    split = 0
    for path, jspec, leaf in _walk(jspecs, local):
        whole = cache
        for p in path:
            whole = whole[p]
        shape = list(whole.shape)
        axis = _jax_axis(jspec, whole.dim())
        if axis is not None:
            shape[axis] //= n
            split += 1
        assert list(leaf.shape) == shape, path
    assert split  # the kv heads split


def _same_refusal(jfn, tfn, exc):
    with pytest.raises(exc) as jerr:
        jfn()
    with pytest.raises(exc) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


def _grouped_params(g):
    jcfg, cfg = _cfgs()
    jp = jquantize_params(jinit_params(jax.random.PRNGKey(0), jcfg), JPolicy(q=2, g=g, iters=1))
    return jcfg, jp, cfg, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _refusal_indivisible_groups():
    jcfg, jp, cfg, tp_params = _grouped_params(128)
    msg = _same_refusal(lambda: jtp.tp_param_specs(jcfg, jp, jdecode_tp_axes(2)),
                        lambda: tp.tp_param_specs(cfg, tp_params, 2), ValueError)
    assert "wo" in msg and "k/g" in msg and "replicated" in msg
    # and through the engine's entry point: shard_model
    with pytest.raises(ValueError, match=r"wo.*k/g"):
        tp.shard_model(cfg, tp_params, _mesh(0, 2))


def _refusal_heads():
    jcfg, cfg = jreduced(jget_config("llama3.2-3b")), reduced(get_config("llama3.2-3b"))  # n_kv_heads=2
    msg = _same_refusal(lambda: jtp.TPContext(jcfg, jtp.make_tp_mesh(4)), lambda: tp.TPContext(cfg, _mesh(0, 4)),
                        ValueError)
    assert "n_kv_heads" in msg


def _refusal_fused_odd_split():
    jcfg, cfg = _cfgs()
    jp = jfuse(jcfg, _jax_params("dense", 0))
    msg = _same_refusal(lambda: jtp.relayout_fused_for_tp(jcfg, jp, 3),
                        lambda: tp.relayout_fused_for_tp(cfg, _port_params("dense", 0, True), 3), ValueError)
    assert "wqkv" in msg


def _refusal_family(arch, block):
    def run():
        jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        msg = _same_refusal(lambda: jtp.TPContext(jcfg, jtp.make_tp_mesh(2)), lambda: tp.TPContext(cfg, _mesh(0, 2)),
                            NotImplementedError)
        assert block in msg
    return run


REFUSALS = {
    "indivisible_groups": _refusal_indivisible_groups,
    "heads": _refusal_heads,
    "fused_odd_split": _refusal_fused_odd_split,
    "recurrent": _refusal_family("recurrentgemma-9b", "rglru"),
    "ssm": _refusal_family("xlstm-125m", "mlstm"),
    "moe": _refusal_family("olmoe-1b-7b", "attn_moe"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_reference(case):
    REFUSALS[case]()


def test_check_tp_refuses_before_ranks_start():
    """``check_tp`` (what the launcher asks before it spawns) raises what
    ``shard_model`` would, and passes a split that divides."""
    _, _, cfg, params = _grouped_params(128)
    with pytest.raises(ValueError, match=r"wo.*k/g"):
        tp.check_tp(cfg, params, 2)
    _, _, cfg, params = _grouped_params(Q_GROUP)
    tp.check_tp(cfg, fuse_decode_projections(cfg, params), 4)


def test_make_tp_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tp.make_tp_mesh(2)
