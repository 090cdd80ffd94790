"""The port's mesh-axis rules (``repro_torch.parallel.sharding``) and
production mesh records (``repro_torch.launch.mesh``) against the JAX
package's, for all 10 architectures × both production meshes:

- ``param_specs`` and ``cache_specs`` (the reference's ``"dh"`` layout)
  equal the reference's leaf for leaf, as tuples;
- every sharded dim of the port's meta ``init_params`` / ``init_cache``
  divides its axis (``tests/test_sharding.py``'s check);
- ``batch_specs``' fallback when the batch does not divide, ``logits_spec``;
- ``qt_specs_like`` on the reference test's two cases, and on every
  registered format's ``struct``, whose shapes and dtypes equal the JAX
  format's ``struct``;
- ``production_axes`` and ``MeshAxes.ranks``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core.formats import get_format as jget_format
from repro.core.qtensor import QuantizedTensor as JQT
from repro.parallel import batch_specs as jbatch_specs
from repro.parallel import cache_specs as jcache_specs
from repro.parallel import multi_pod_axes as jmulti_pod_axes
from repro.parallel import param_specs as jparam_specs
from repro.parallel import single_pod_axes as jsingle_pod_axes
from repro.parallel.sharding import logits_spec as jlogits_spec
from repro.parallel.sharding import qt_specs_like as jqt_specs_like
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.formats import format_names, get_format
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.launch.mesh import production_axes
from repro_torch.models import init_cache, init_params
from repro_torch.parallel.sharding import (
    MeshAxes,
    Spec,
    batch_specs,
    cache_specs,
    logits_spec,
    multi_pod_axes,
    param_specs,
    qt_specs_like,
    single_pod_axes,
)

AXES = {"single": single_pod_axes(), "multi": multi_pod_axes()}
JAXES = {"single": jsingle_pod_axes(), "multi": jmulti_pod_axes()}
CACHE_BATCH, CACHE_SEQ = 128, 1024  # the reference test's cache


def _flat(tree, path=()):
    """{path: spec as a tuple} of a spec tree of either package."""
    if isinstance(tree, (Spec, P)):
        return {path: tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
    else:
        raise TypeError(f"{path}: {type(tree)} is not a spec")
    return out


def _shapes(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_shapes(v, path + (k,)))
    return out


def _check_divisible(shapes, specs, ax, where):
    assert shapes.keys() == specs.keys(), where
    for path, spec in specs.items():
        shape = shapes[path]
        assert len(spec) <= len(shape), f"{where}{path}: rank {spec} {shape}"
        for dim, axis in zip(shape, spec):
            if axis is not None:
                assert dim % ax.size(axis) == 0, f"{where}{path}: {dim} not divisible by {axis}"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_param_specs_equal_reference_and_divide(arch, mesh_kind):
    cfg, ax = get_config(arch), AXES[mesh_kind]
    specs = _flat(param_specs(cfg, ax))
    assert specs == _flat(jparam_specs(jget_config(arch), JAXES[mesh_kind]))
    _check_divisible(_shapes(init_params(cfg, device="meta")), specs, ax, f"{arch}/{mesh_kind}/params")


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_cache_specs_equal_reference_and_divide(arch, mesh_kind):
    cfg, ax = get_config(arch), AXES[mesh_kind]
    specs = _flat(cache_specs(cfg, ax, CACHE_BATCH))
    assert specs == _flat(jcache_specs(jget_config(arch), JAXES[mesh_kind], CACHE_BATCH, "dh"))
    shapes = _shapes(init_cache(cfg, CACHE_BATCH, CACHE_SEQ, device="meta"))
    _check_divisible(shapes, specs, ax, f"{arch}/{mesh_kind}/cache")


def test_int8_cache_specs_equal_reference():
    import dataclasses

    cfg = dataclasses.replace(get_config("llama3.2-3b"), kv_cache_dtype="int8", stages=None)
    jcfg = dataclasses.replace(jget_config("llama3.2-3b"), kv_cache_dtype="int8", stages=None)
    for kind in AXES:
        specs = _flat(cache_specs(cfg, AXES[kind], CACHE_BATCH))
        assert specs == _flat(jcache_specs(jcfg, JAXES[kind], CACHE_BATCH))
        assert specs[("stages", 0, "b0", "k_scale")] == tuple(Spec(None, AXES[kind].dp, None, None))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "musicgen-medium", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("batch", [1, 32, 256])
def test_batch_and_logits_specs_equal_reference(arch, batch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kind in AXES:
        assert _flat(batch_specs(cfg, AXES[kind], batch)) == _flat(jbatch_specs(jcfg, JAXES[kind], batch))
        assert tuple(logits_spec(cfg, AXES[kind], batch)) == tuple(jlogits_spec(jcfg, JAXES[kind], batch))


def test_batch_specs_fall_back_when_indivisible():
    cfg = get_config("llama3.2-3b")
    ax = multi_pod_axes()  # dp = 32
    assert tuple(batch_specs(cfg, ax, 1)["tokens"]) == (None, None)  # long_500k's batch of 1
    assert tuple(batch_specs(cfg, ax, 256)["tokens"])[0] == ("pod", "data")
    assert tuple(logits_spec(cfg, ax, 1)) == (None, None, "model")  # vocab 128256 = 16 · 8016


def test_qt_specs_like_reference_cases():
    ax = single_pod_axes()
    meta = dict(device="meta")
    qt = QuantizedTensor(
        packed=torch.empty((4, 384, 8192), dtype=torch.uint8, **meta),
        scales=torch.empty((4, 24, 8192), dtype=torch.bfloat16, **meta),
        g=128, k=3072, o=8192,
    )
    spec = qt_specs_like(Spec("data", "model"), qt, ax)
    assert tuple(spec.packed) == (None, "data", "model")
    # scales k-dim 24 not divisible by 16 → replicated on that dim
    assert tuple(spec.scales) == (None, None, "model")
    qt2 = QuantizedTensor(
        packed=torch.empty((28, 4, 384, 8192), dtype=torch.uint8, **meta),
        scales=torch.empty((28, 4, 24, 8192), dtype=torch.bfloat16, **meta),
        g=128, k=3072, o=8192,
    )
    spec2 = qt_specs_like(Spec(None, "data", "model"), qt2, ax)
    assert tuple(spec2.packed) == (None, None, "data", "model")
    assert (spec2.g, spec2.k, spec2.o, spec2.fmt) == (128, 3072, 8192, "bcq")


@pytest.mark.parametrize("fmt", format_names())
@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("lead,k,o,g,dense", [
    ((), 3072, 8192, 128, ("data", "model")),
    ((28,), 8192, 3072, 128, (None, "model", "data")),
    ((2, 4), 2048, 4096, 2048, (None, "model", "data", None)),
])
def test_struct_and_qt_specs_equal_reference(fmt, q, lead, k, o, g, dense):
    ax, jax_ax = single_pod_axes(), jsingle_pod_axes()
    st = get_format(fmt).struct(lead, k, o, q, g, torch.bfloat16)
    jst = jget_format(fmt).struct(lead, k, o, q, g, jnp.bfloat16)
    assert st.packed.device.type == "meta" and st.scales.device.type == "meta"
    assert tuple(st.packed.shape) == tuple(jst.packed.shape)
    assert tuple(st.scales.shape) == tuple(jst.scales.shape)
    assert st.packed.dtype == torch.uint8 and st.scales.dtype == torch.bfloat16
    assert (st.g, st.k, st.o, st.fmt) == (jst.g, jst.k, jst.o, jst.fmt)
    if fmt == "ternary":
        assert st.packed.shape[-3] == 2  # two planes whatever q says
    spec = qt_specs_like(Spec(*dense), st, ax)
    jspec = jqt_specs_like(P(*dense), jst, jax_ax)
    assert isinstance(jspec, JQT)
    assert (tuple(spec.packed), tuple(spec.scales)) == (tuple(jspec.packed), tuple(jspec.scales))


def test_spec_type():
    s = Spec(None, ("pod", "data"), "model")
    assert tuple(s) == (None, ("pod", "data"), "model") == tuple(P(None, ("pod", "data"), "model"))
    assert len(s) == 3 and s[1] == ("pod", "data") and s == Spec(None, ["pod", "data"], "model")
    assert s != (None, ("pod", "data"), "model") and hash(s) == hash(Spec(*s))
    assert tuple(Spec()) == () and repr(Spec("data")) == "Spec('data',)"
    assert tuple(Spec(("data",), ())) == ("data", None) == tuple(P(("data",), ()))


def test_production_mesh_records():
    single, multi = production_axes(), production_axes(multi_pod=True)
    assert single == single_pod_axes(16, 16) and multi == multi_pod_axes(2, 16, 16)
    assert (single.data_size, single.model_size, multi.data_size, multi.model_size) == (16, 16, 32, 16)
    assert (single.dp, single.fsdp, single.model) == (("data",), "data", "model")
    assert multi.dp == ("pod", "data") and multi.size(("pod", "data")) == 32 and multi.size(None) == 1
    assert (single.ranks, multi.ranks, MeshAxes((), None, "model", (("model", 2),)).ranks) == (256, 512, 2)
    for kind, jax_ax in JAXES.items():
        assert AXES[kind].sizes == jax_ax.sizes and AXES[kind].dp == jax_ax.dp
