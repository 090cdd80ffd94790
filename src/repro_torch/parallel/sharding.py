"""Mesh-axis rules for every parameter / cache / batch tensor (counterpart of
``repro/parallel/sharding.py``).

Strategy: everything is expressed in axis *names*, so meshes of any size
reuse the same rules:

- batch (DP) over ``dp = ("pod", "data")`` (or ``("data",)`` single-pod)
- FSDP (ZeRO-3) over ``fsdp = "data"``: params' non-TP dim sharded in-pod,
  replicated across pods (all-gathers stay inside a pod; only the gradient
  all-reduce crosses pods)
- TP over ``model``: attention heads / FFN hidden / vocab / LRU width
- EP over ``model``: the MoE expert dim
- KV caches: batch over ``dp`` (when divisible), head_dim over ``model``

Spec trees mirror ``models.model.init_params`` / ``init_cache`` leaf for
leaf, :class:`~repro_torch.core.qtensor.QuantizedTensor` nodes included
(their planes get specs derived from the dense weight's, :func:`qt_specs_like`).
A spec is a :class:`Spec`, the port's stand-in for JAX's ``PartitionSpec``.

The rules' consumer is the dry run (``launch/dryrun.py``: per-rank bytes
and the collectives of every cell). TP serving places its own tensors
(``parallel/tp.py``; a rank's cache is ``init_cache`` of
``TPContext.cfg_local``, the reference's ``"heads"`` cache layout). Eager
PyTorch has no ambient GSPMD mesh: nothing here places a tensor, the rules
only say how a mesh would split it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.models.config import ModelConfig
from repro_torch.utils import tree_map

Axis = Optional[str]


def _entry(axis):
    """A spec entry as ``PartitionSpec`` keeps it: a sequence of one axis is
    that axis, an empty one None."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return axis[0] if len(axis) == 1 else (axis or None)
    return axis


class Spec:
    """A mesh-axis spec, one entry a leading dim of its tensor: an axis name,
    a tuple of names (the dim split over several axes, e.g. ``("pod",
    "data")``; a tuple of one name is that name) or None (the dim stays
    whole); dims past the entries stay whole. It iterates and indexes like
    the tuple of its entries, so ``tuple(spec)`` equals
    ``tuple(PartitionSpec(...))`` of the same rule; it is not a tuple
    itself, so the parameter-tree walkers (``utils.tree_map``) take it for
    a leaf."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(_entry(a) for a in axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"Spec{self.axes!r}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]  # batch axes (pure DP; ("pod", "data") multi-pod)
    fsdp: Optional[str]  # param-shard axis (ZeRO-3); None disables FSDP
    model: str  # TP / EP axis
    sizes: Tuple[Tuple[str, int], ...]  # axis name → size

    def size(self, name) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            n = 1
            for a in name:
                n *= self.size(a)
            return n
        return dict(self.sizes)[name]

    @property
    def data_size(self) -> int:
        return self.size(self.dp)

    @property
    def model_size(self) -> int:
        return self.size(self.model)

    @property
    def ranks(self) -> int:
        """The ranks the mesh holds: the product of its axes' sizes."""
        return self.size(tuple(n for n, _ in self.sizes))


def single_pod_axes(data: int = 16, model: int = 16) -> MeshAxes:
    return MeshAxes(("data",), "data", "model", (("data", data), ("model", model)))


def multi_pod_axes(pod: int = 2, data: int = 16, model: int = 16) -> MeshAxes:
    return MeshAxes(
        ("pod", "data"),
        "data",
        "model",
        (("pod", pod), ("data", data), ("model", model)),
    )


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _maybe(axis, dim: int, size: int):
    """Use ``axis`` only if it divides ``dim`` (else replicate that dim)."""
    if axis is None:
        return None
    return axis if _div(dim, size) else None


# ---------------------------------------------------------------------------
# per-block parameter specs (mirrors models.model.init_block)
# ---------------------------------------------------------------------------


def _wspec(cfg: ModelConfig, ax: MeshAxes, k: int, o: int, k_ax, o_ax) -> Spec:
    """Spec for a (k, o) weight; axes dropped when they don't divide."""
    return Spec(_maybe(k_ax, k, ax.size(k_ax)), _maybe(o_ax, o, ax.size(o_ax)))


def _attn_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    f, m = ax.fsdp, ax.model
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": _wspec(cfg, ax, d, qd, f, m),
        "wk": _wspec(cfg, ax, d, kvd, f, m),
        "wv": _wspec(cfg, ax, d, kvd, f, m),
        "wo": _wspec(cfg, ax, qd, d, m, f),
    }


def _mlp_specs(cfg: ModelConfig, ax: MeshAxes, d_ff: Optional[int] = None) -> dict:
    f, m = ax.fsdp, ax.model
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": _wspec(cfg, ax, d, ff, f, m),
        "w_up": _wspec(cfg, ax, d, ff, f, m),
        "w_down": _wspec(cfg, ax, ff, d, m, f),
    }


def _moe_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    f, m = ax.fsdp, ax.model
    d, e = cfg.d_model, cfg.n_experts
    em = _maybe(m, e, ax.size(m))  # EP: experts over model axis
    df = _maybe(f, d, ax.size(f))
    s = {
        "router": Spec(df, None),
        "w_gate": Spec(em, df, None),
        "w_up": Spec(em, df, None),
        "w_down": Spec(em, None, df),
    }
    if cfg.shared_expert:
        s["shared"] = _mlp_specs(cfg, ax)
    return s


def _rglru_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    f, m = ax.fsdp, ax.model
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_x": _wspec(cfg, ax, d, w, f, m),
        "w_y": _wspec(cfg, ax, d, w, f, m),
        "conv_w": Spec(None, _maybe(m, w, ax.size(m))),
        "w_a": _wspec(cfg, ax, w, w, f, m),
        "w_i": _wspec(cfg, ax, w, w, f, m),
        "lam": Spec(_maybe(m, w, ax.size(m))),
        "w_out": _wspec(cfg, ax, w, d, m, f),
    }


def _mlstm_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    f, m = ax.fsdp, ax.model
    d = cfg.d_model
    inner = int(d * cfg.mlstm_proj_factor)
    return {
        "w_up": _wspec(cfg, ax, d, inner, f, m),
        "w_z": _wspec(cfg, ax, d, inner, f, m),
        "wq": _wspec(cfg, ax, inner, inner, f, m),
        "wk": _wspec(cfg, ax, inner, inner, f, m),
        "wv": _wspec(cfg, ax, inner, inner, f, m),
        "w_i": Spec(_maybe(f, inner, ax.size(f)), None),
        "w_f": Spec(_maybe(f, inner, ax.size(f)), None),
        "w_down": _wspec(cfg, ax, inner, d, m, f),
        "skip_scale": Spec(_maybe(m, inner, ax.size(m))),
    }


def _slstm_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    f, m = ax.fsdp, ax.model
    d = cfg.d_model
    # r_* (hidden-to-hidden, per head) must be REPLICATED: sharding them puts a
    # collective-permute inside every timestep of the sequential scan (the
    # reference measured it: it made xlstm train_4k collective-bound at 2.8
    # s/step).
    rspec = Spec(None, None, None)
    s = {f"w_{g}": _wspec(cfg, ax, d, d, f, m) for g in ("z", "i", "f", "o")}
    s.update({f"r_{g}": rspec for g in ("z", "i", "f", "o")})
    s["w_out"] = _wspec(cfg, ax, d, d, m, f)
    return s


def block_specs(cfg: ModelConfig, ax: MeshAxes, btype: str) -> dict:
    s = {"ln1": Spec(None)}
    if btype in ("attn", "local_attn", "cross", "attn_moe"):
        s["attn"] = _attn_specs(cfg, ax)
        s["ln2"] = Spec(None)
        s["mlp"] = _moe_specs(cfg, ax) if btype == "attn_moe" else _mlp_specs(cfg, ax)
    elif btype == "rglru":
        s["mix"] = _rglru_specs(cfg, ax)
        s["ln2"] = Spec(None)
        s["mlp"] = _mlp_specs(cfg, ax)
    elif btype == "mlstm":
        s["mix"] = _mlstm_specs(cfg, ax)
    elif btype == "slstm":
        s["mix"] = _slstm_specs(cfg, ax)
    else:
        raise ValueError(btype)
    return s


def _stack(spec_tree):
    """Prepend the stacked layer dim (replicated) to every spec."""
    return tree_map(lambda p: Spec(None, *p), spec_tree)


def param_specs(cfg: ModelConfig, ax: MeshAxes) -> dict:
    f, m = ax.fsdp, ax.model
    stages = []
    for pattern, _ in cfg.stages:
        stages.append(
            {f"b{bi}": _stack(block_specs(cfg, ax, bt)) for bi, bt in enumerate(pattern)}
        )
    specs = {
        "stages": tuple(stages),
        "final_norm": Spec(None),
        "lm_head": _wspec(cfg, ax, cfg.d_model, cfg.vocab, f, m),
    }
    if cfg.input_kind == "tokens":
        specs["embed"] = _wspec(cfg, ax, cfg.vocab, cfg.d_model, m, f)
    return specs


# ---------------------------------------------------------------------------
# cache specs (mirrors models.model.init_cache)
# ---------------------------------------------------------------------------


def _cache_block_specs(cfg: ModelConfig, ax: MeshAxes, btype: str, batch: int) -> dict:
    b_ax = ax.dp if (ax.dp and _div(batch, ax.data_size)) else None
    m = ax.model
    if btype in ("attn", "attn_moe", "local_attn", "cross"):
        # KV layout: head_dim over `model` (the GSPMD decode / training
        # rule). Sequence-sharding (flash-decoding-style split-K) was tried
        # in the reference and REJECTED: a dynamic-position update into a
        # sequence-sharded dim makes GSPMD reshard the whole cache every step
        # (it measured 179 GB/chip/step on llama3.2-3b decode_32k).
        # Dh-sharding keeps writes local; the per-layer score partial-sum is
        # the cost. (The reference's other layout, kv heads over `model` for
        # TP serving, is the port's TP cache: ``init_cache`` of
        # ``TPContext.cfg_local``.)
        dh_ax = _maybe(m, cfg.d_head, ax.size(m))
        s = Spec(None, b_ax, None, None, dh_ax)
        sc = Spec(None, b_ax, None, None)
        if btype == "cross":
            return {"k_img": s, "v_img": s}
        if cfg.kv_cache_dtype == "int8":
            return {"k": s, "v": s, "k_scale": sc, "v_scale": sc}
        return {"k": s, "v": s}
    if btype == "rglru":
        w_ax = _maybe(m, cfg.lru_width, ax.size(m))
        return {
            "h": Spec(None, b_ax, w_ax),
            "conv": Spec(None, b_ax, None, w_ax),
        }
    if btype == "mlstm":
        inner = int(cfg.d_model * cfg.mlstm_proj_factor)
        dhi_ax = _maybe(m, inner // cfg.n_heads, ax.size(m))
        return {
            "c": Spec(None, b_ax, None, dhi_ax, None),
            "n": Spec(None, b_ax, None, dhi_ax),
            "m": Spec(None, b_ax, None),
        }
    if btype == "slstm":
        dh_s = _maybe(m, cfg.d_model // cfg.n_heads, ax.size(m))
        s = Spec(None, b_ax, None, dh_s)
        return {k: s for k in ("h", "c", "n", "m")}
    raise ValueError(btype)


def cache_specs(cfg: ModelConfig, ax: MeshAxes, batch: int) -> dict:
    """Spec tree mirroring ``init_cache``, the reference's ``layout="dh"``
    rule (head_dim over model)."""
    stages = tuple(
        {f"b{bi}": _cache_block_specs(cfg, ax, bt, batch) for bi, bt in enumerate(pattern)}
        for pattern, _ in cfg.stages
    )
    return {"stages": stages}


# ---------------------------------------------------------------------------
# batch / IO specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, ax: MeshAxes, batch: int) -> dict:
    """Specs for the input batch dict used by the train / prefill / decode
    steps; the batch stays whole where the dp axes do not divide it."""
    b_ax = ax.dp if (ax.dp and _div(batch, ax.data_size)) else None
    out = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = Spec(b_ax, None)
        out["labels"] = Spec(b_ax, None)
    else:
        out["embeddings"] = Spec(b_ax, None, None)
        out["labels"] = Spec(b_ax, None)
    if cfg.family == "vlm":
        out["image_emb"] = Spec(b_ax, None, None)
    return out


def logits_spec(cfg: ModelConfig, ax: MeshAxes, batch: int) -> Spec:
    b_ax = ax.dp if (ax.dp and _div(batch, ax.data_size)) else None
    v_ax = _maybe(ax.model, cfg.vocab, ax.size(ax.model))
    return Spec(b_ax, None, v_ax)


# ---------------------------------------------------------------------------
# QuantizedTensor spec derivation
# ---------------------------------------------------------------------------


def qt_specs_like(dense_spec: Spec, qt: QuantizedTensor, ax: MeshAxes) -> QuantizedTensor:
    """A QuantizedTensor whose planes are :class:`Spec` s, matching the dense
    weight's (possibly layer-stacked) spec ``(…lead, k_ax, o_ax)``: the
    reference's GSPMD rule, which its formats call ``tp_specs``, shared by
    every registered format.

    Shared-layout rule: the packed k-rows (``k/8``) and the scale groups
    (``k/g``) shard along ``k_ax`` only when the mesh axis divides them, so
    group scales travel WITH the k-rows they scale (the paper's group-wise-TP
    argument, §V.C); an axis that does not divide is dropped (replicated).
    The plane dim stays whole."""
    *lead, k_ax, o_ax = tuple(dense_spec)
    kc = qt.packed.shape[-2]
    kg = qt.scales.shape[-2]
    return qt.replace(
        packed=Spec(*lead, None, _maybe(k_ax, kc, ax.size(k_ax)), o_ax),
        scales=Spec(*lead, None, _maybe(k_ax, kg, ax.size(k_ax)), o_ax),
    )
