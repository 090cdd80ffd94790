"""Tensor-parallel quantized serving: every rank runs the decode stack on
its shards (counterpart of ``repro/parallel/tp.py``).

The paper's multi-GPU latency model (§V.C) assumes the quantized GEMV
shards cleanly: group-wise BCQ keeps every scale next to the k-rows it
scales, so a weight split along either logical dim carries its packed
planes *and* its group scales with it, and each rank runs the same kernel
on a smaller problem, with no dequantize-then-reshard step.

- **column-parallel** (``wq``/``wk``/``wv``/``wqkv``, ``w_gate``/``w_up``/
  ``w_gate_up``, ``lm_head``): the output dim splits. Each rank projects
  its own attention heads / FFN columns / vocab slice from the replicated
  activation, with no collective. A fused leaf (``wqkv``, ``w_gate_up``)
  is re-interleaved first (:func:`relayout_fused_for_tp`), so rank ``r``'s
  contiguous slice holds ``[q_r | k_r | v_r]`` and the local
  ``linear_fused`` split keeps working with local dims.
- **row-parallel** (``wo``, ``w_down``): the reduction dim splits; the local
  products are partial sums, all-reduced back into the replicated residual
  stream (``parallel/ctx.py::psum_partial``). Group scales split with their
  groups, which needs ``(k / g) % tp == 0``: checked, below.
- **KV caches**: the kv-head dim splits, matching the local heads, so
  attention and rope stay rank-local: a rank's cache is ``init_cache`` of
  the local config (:attr:`TPContext.cfg_local`), which is the reference's
  ``layout="heads"`` cache rule.
- **replicated**: norms, the embedding, per-slot counters, generators and
  logits, the activations between blocks.

A forward issues one all-reduce per attention block (after ``wo``), one per
MLP (after ``w_down``) and one all-gather of the vocab-split logits:
2·L + 1 collectives, never a weight or cache gather.

Divisibility is strict: :func:`tp_param_specs` raises a ``ValueError``
naming the leaf and the offending dims instead of serving a weight whole on
every rank. The format derives its planes' split axes
(``QuantFormat.tp_specs``); this module refuses when it had to drop one.

The port's "mesh" (:class:`TPMesh`, :func:`make_tp_mesh`) is an initialised
``torch.distributed`` process group: one process per rank, each of which
builds the same :class:`~repro_torch.infer.Engine` and keeps only its own
slice of every leaf (:func:`shard_model`). ``launch/_ranks.py`` starts the
ranks. Entry point: :func:`shard_model` → ``(local params, TPContext)``; the
engine calls :meth:`TPContext.forward` wherever it would call
``models.forward`` (``Engine(mesh=...)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.ctx import tp_shard_region
from repro_torch.utils import tree_map, tree_map_with_path

# leaves that split along the output dim (heads / FFN columns / vocab)
_COLUMN_PARALLEL = frozenset(
    {"wq", "wk", "wv", "wqkv", "w_gate", "w_up", "w_gate_up", "lm_head"}
)
# leaves that split along the reduction dim (partial sums all-reduced back)
_ROW_PARALLEL = frozenset({"wo", "w_down"})
# block types TP serving supports. MoE is excluded for the same reason as
# slot serving (expert capacity couples batch rows); recurrent state mixes
# the full width inside the per-step scan, which would put a collective in
# every timestep.
_TP_BLOCKS = frozenset({"attn", "local_attn", "cross"})


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """A 1-D ``model`` mesh: this process's rank in the initialised default
    ``torch.distributed`` group of ``size`` ranks, and its backend.
    ``device`` holds the tensors of a host decision every rank must take
    alike (``ctx.agree``): the rank's card under NCCL, the host under
    gloo."""

    rank: int
    size: int
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict:
        """Axis name → size, as a JAX mesh's ``shape``."""
        return {"model": self.size}


def make_tp_mesh(tp: int) -> TPMesh:
    """The ``(tp,)`` mesh of this process's default process group, which
    must be initialised with ``tp`` ranks (``launch/_ranks.py`` starts
    them)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"--tp {tp} needs an initialised torch.distributed process group of {tp} ranks, "
            "and this process has none; start the ranks with "
            "repro_torch.launch._ranks.run_ranks (python -m repro_torch.launch.serve --tp N does)"
        )
    size = dist.get_world_size()
    if size != tp:
        raise RuntimeError(
            f"--tp {tp} needs a process group of {tp} ranks, but this one has {size}"
        )
    backend = str(dist.get_backend())
    device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    return TPMesh(rank=dist.get_rank(), size=size, backend=backend, device=device)


# ---------------------------------------------------------------------------
# strict TP spec derivation (walks the actual, possibly fused, param tree)
# ---------------------------------------------------------------------------


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _require_div(dim: int, n: int, where: str, what: str, hint: str = "") -> None:
    if dim % n:
        raise ValueError(
            f"TP: cannot shard {where}: {what}={dim} is not divisible by the "
            f"model mesh axis size {n}{'; ' + hint if hint else ''} "
            "(refusing to serve a silently replicated weight)"
        )


def _qt_spec(path, qt: QuantizedTensor, n: int, kind: str) -> Tuple:
    where = _path_str(path)
    if kind == "col":
        _require_div(qt.o, n, where, f"output dim o (k={qt.k}, o={qt.o})")
    else:  # row
        _require_div(
            qt.packed.shape[-2], n, where,
            f"packed k/8 dim {qt.packed.shape[-2]} (k={qt.k})",
        )
        _require_div(
            qt.scales.shape[-2], n, where,
            f"group-scale k/g dim {qt.scales.shape[-2]} (k={qt.k}, g={qt.g})",
            hint=f"pick a group size dividing k/tp, i.e. g | {qt.k // n}",
        )
    # the format owns the planes' split axes (group scales split WITH their
    # k-row groups; an axis that does not divide is dropped)
    spec = get_format(qt.fmt).tp_specs(qt, kind, n)
    for plane, axis in (("packed", spec[0]), ("scales", spec[1])):
        if axis is None:
            raise ValueError(
                f"TP: {qt.fmt!r} tp_specs replicated the {plane} plane of {where} "
                f"({dict(packed=tuple(qt.packed.shape), scales=tuple(qt.scales.shape))[plane]})"
                " — the dims above should have caught this"
            )
    return spec


def tp_param_specs(cfg: ModelConfig, params, n: int):
    """The split axes of an actual (possibly decode-fused) param tree, in
    its tree: ``(packed axis, scales axis)`` for a quantized leaf, an axis
    for a dense one, None for a leaf every rank holds whole.

    Column / row assignment is by leaf name; everything else (norms, the
    embedding, biases) is replicated. Raises, naming the leaf and dims,
    whenever a dim that must split does not divide ``n``."""

    def visit(path, leaf):
        name = str(path[-1])
        where = _path_str(path)
        if isinstance(leaf, QuantizedTensor):
            if name in _COLUMN_PARALLEL:
                return _qt_spec(path, leaf, n, "col")
            if name in _ROW_PARALLEL:
                return _qt_spec(path, leaf, n, "row")
            return (None, None)
        if name in _COLUMN_PARALLEL:
            _require_div(leaf.shape[-1], n, where, f"output dim {leaf.shape[-1]}")
            return -1
        if name in _ROW_PARALLEL:
            _require_div(leaf.shape[-2], n, where, f"reduction dim {leaf.shape[-2]}")
            return -2
        return None

    return tree_map_with_path(visit, params)


# ---------------------------------------------------------------------------
# fused-leaf column re-layout
# ---------------------------------------------------------------------------


def _interleave_perm(out_dims: Sequence[int], n: int) -> np.ndarray:
    """Column permutation turning ``[p0 | p1 | ...]`` (projections whole) into
    ``[p0_0 p1_0 ... | p0_1 p1_1 ...]`` (rank shards whole)."""
    starts, off = [], 0
    for d in out_dims:
        starts.append(off)
        off += d
    idx = []
    for dev in range(n):
        for st, d in zip(starts, out_dims):
            loc = d // n
            idx.extend(range(st + dev * loc, st + (dev + 1) * loc))
    return np.asarray(idx, np.int64)


def _permute_cols(leaf, out_dims: Tuple[int, ...], n: int, where: str):
    for d in out_dims:
        _require_div(
            d, n, where,
            f"fused projection output dim {d} (of o_total split {out_dims})",
        )
    dev = (leaf.packed if isinstance(leaf, QuantizedTensor) else leaf).device
    idx = torch.from_numpy(_interleave_perm(out_dims, n)).to(dev)
    if isinstance(leaf, QuantizedTensor):
        return leaf.replace(packed=leaf.packed.index_select(-1, idx), scales=leaf.scales.index_select(-1, idx))
    return leaf.index_select(-1, idx)


def relayout_fused_for_tp(cfg: ModelConfig, params, n: int):
    """Re-interleave fused ``wqkv`` / ``w_gate_up`` output columns so each of
    the ``n`` contiguous shards holds that rank's slice of EVERY projection
    (the local ``linear_fused`` split then uses local per-projection dims).

    Identity for ``n == 1`` and for unfused trees."""
    if n == 1:
        return params
    stages = []
    for si, (pattern, _) in enumerate(cfg.stages):
        stage_p = dict(params["stages"][si])
        for bi, _btype in enumerate(pattern):
            bp = dict(stage_p[f"b{bi}"])
            attn = bp.get("attn")
            if isinstance(attn, dict) and "wqkv" in attn:
                attn = dict(attn)
                attn["wqkv"] = _permute_cols(
                    attn["wqkv"], (cfg.q_dim, cfg.kv_dim, cfg.kv_dim), n,
                    f"stages/{si}/b{bi}/attn/wqkv",
                )
                bp["attn"] = attn
            mlp = bp.get("mlp")
            if isinstance(mlp, dict) and "w_gate_up" in mlp:
                mlp = dict(mlp)
                w = mlp["w_gate_up"]
                o = w.o if isinstance(w, QuantizedTensor) else w.shape[-1]
                mlp["w_gate_up"] = _permute_cols(
                    w, (o // 2, o // 2), n, f"stages/{si}/b{bi}/mlp/w_gate_up"
                )
                bp["mlp"] = mlp
            stage_p[f"b{bi}"] = bp
        stages.append(stage_p)
    return dict(params, stages=tuple(stages))


# ---------------------------------------------------------------------------
# this rank's slices
# ---------------------------------------------------------------------------


def _take(t: torch.Tensor, axis: Optional[int], n: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous ``1/n`` of ``t`` along ``axis`` (a copy,
    so the whole tensor can be freed); ``t`` itself for None."""
    if axis is None:
        return t
    size = t.shape[axis] // n
    return t.narrow(axis, rank * size, size).contiguous()


def _relocalize(params):
    """Fix every QuantizedTensor's static ``(k, o)`` to its shard's shape
    (the format owns the packed-rows → k relation:
    ``QuantFormat.relocalize``)."""

    def fix(leaf):
        if isinstance(leaf, QuantizedTensor):
            return get_format(leaf.fmt).relocalize(leaf)
        return leaf

    return tree_map(fix, params)


def local_slices(tree, specs, n: int, rank: int):
    """Rank ``rank``'s slice of every leaf of ``tree`` by the split axes of
    ``specs`` (:func:`tp_param_specs`'s tree of split axes), quantized
    leaves with their local ``(k, o)``."""

    def take(path, leaf):
        spec = specs
        for p in path:
            spec = spec[p]
        if isinstance(leaf, QuantizedTensor):
            return leaf.replace(packed=_take(leaf.packed, spec[0], n, rank),
                                scales=_take(leaf.scales, spec[1], n, rank))
        return _take(leaf, spec, n, rank)

    return _relocalize(tree_map_with_path(take, tree))


def _check_config(cfg: ModelConfig, n: int) -> None:
    """The refusals of a config that ``n``-way TP serving cannot split."""
    blocks = {bt for pattern, _ in cfg.stages for bt in pattern}
    bad = sorted(blocks - _TP_BLOCKS)
    if bad:
        raise NotImplementedError(
            f"tensor-parallel serving supports attention-family blocks "
            f"{sorted(_TP_BLOCKS)}; config {cfg.name!r} has {bad} "
            "(MoE couples batch rows through expert capacity; recurrent "
            "blocks would put a collective inside every scan timestep)"
        )
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(
            f"TP: config {cfg.name!r} heads (n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads}) not divisible by tp={n}"
        )


def check_tp(cfg: ModelConfig, params, n: int) -> None:
    """Raise what ``shard_model`` would raise for an ``n``-way split of
    ``params`` (a possibly decode-fused tree), without a process group: a
    launcher asks before it starts the ranks."""
    _check_config(cfg, n)
    tp_param_specs(cfg, relayout_fused_for_tp(cfg, params, n), n)


class TPContext:
    """Per-engine tensor-parallel state: the mesh, the local view of the
    config, and the sharded ``forward``."""

    def __init__(self, cfg: ModelConfig, mesh: TPMesh):
        self.mesh = mesh
        self.n = mesh.size
        _check_config(cfg, self.n)
        self.cfg = cfg
        # the rank computes with its own head counts; q_dim / kv_dim follow
        # (q_dim = n_heads·d_head, d_head is fixed), everything else is global
        self.cfg_local = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // self.n, n_kv_heads=cfg.n_kv_heads // self.n
        )

    def forward(self, params, **kw):
        """Drop-in for ``functools.partial(models.forward, cfg)``: this
        rank's forward over its local params and cache inside the TP region,
        the logits returned whole (gathered)."""
        from repro_torch.models.model import forward as _forward

        with tp_shard_region(self.mesh):
            return _forward(self.cfg_local, params, **kw)


def shard_model(cfg: ModelConfig, params, mesh: TPMesh):
    """Keep this rank's slice of a (possibly decode-fused) param tree.

    Returns ``(local params, TPContext)``. Fused leaves are column
    re-interleaved first, so a plain output-dim split hands each rank its
    slice of every projection; the specs are derived next and the slices
    cut last, each a copy on the leaf's device. Any dim that must split but
    does not divide the mesh axis raises (leaf and dims in the message)."""
    tpc = TPContext(cfg, mesh)
    params = relayout_fused_for_tp(cfg, params, tpc.n)
    return local_slices(params, tp_param_specs(cfg, params, tpc.n), tpc.n, mesh.rank), tpc
