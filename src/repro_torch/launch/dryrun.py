"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh × q) cell, run the port's own
train, prefill or decode step once on shapes alone and record what one rank
of the production mesh (``launch/mesh.py``) holds, computes and
communicates, in the reference's JSON layout. No weight is allocated and no
device is needed: the arguments are meta tensors (``init_params`` /
``init_cache`` on ``device="meta"``, ``quant.quantized_structs``), and the
step runs on meta tensors too.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>__q<q>[__kvq8].json``
and existing cells are skipped (a resumable sweep; ``--force`` redoes them).

How a cell is measured (the reference reads XLA's ``memory_analysis`` and
``cost_analysis`` of the compiled SPMD program; eager PyTorch compiles
nothing, so these rules stand in for them):

- **Argument and output bytes per rank are exact.** Each leaf's bytes are
  divided by the product of the mesh-axis sizes in its spec
  (``parallel/sharding.py``; ``_maybe`` keeps only axes that divide, so the
  division is exact): params (packed where quantized), AdamW's ``m`` / ``v``
  and ``step``, the cache and the batch. Output bytes use the out specs on
  the traced step's outputs. ``argument_parts`` splits the arguments.
- **The trace.** The step runs once on meta tensors (the meta kernels that
  ``FakeTensorMode`` propagates shapes with, without its wrappers: 4x
  faster per op, which a train step's 4096-step plain scans need), inside
  ``FlopCounterMode`` (FLOPs by its formulas: matmuls, attention,
  convolutions; elementwise work counts none) and a dispatch mode of this
  module that adds up, per op, the bytes of its distinct tensor inputs and
  outputs (a view, an op whose outputs all alias its inputs without
  writing them and a metadata query with no tensor output move none; so
  does an allocation that writes nothing, ``empty*``) and tracks the live
  bytes of every storage the step creates (a storage counts from the op
  that makes it until it is freed). The trace takes the route the port's steps take on the card under
  ``impl_mode("ref")``: no hand-written kernel (the plain
  dequantize-then-multiply products and the plain attention, as the
  reference lowers its dry run through its jnp path), and every product in
  the GPU's zero-padded tiles of 8 decode rows or 128 prompt rows
  (``utils.matmul_rows`` inside ``utils.row_tiles``: a CPU-only build
  cannot make CUDA tensors, not even fake ones). The counted
  FLOPs and bytes are that route's: the tiles' padding where the rows are
  not a multiple of the tile, and a quantized leaf's dequantization round
  trip (``bcq_hbm_adjustment`` says how many of those bytes the packed
  kernels do not move).
- **Depth.** Each stage's layers are stacked, so every repeat runs the same
  ops on the same shapes: a prefill or decode cell traces its model at one
  and at two repeats of each stage and extrapolates linearly to the full
  depth (``trace_cell``), exact for FLOPs and bytes; its peak, one layer's
  temporaries beside the outputs, does not grow with depth. A train cell
  traces every layer: its peak holds every layer's gradients and the
  optimizer's temporaries of the largest stacked leaf, which no line
  through two shallow traces predicts. ``trace.whole`` says which.
- **Scans.** The plain RG-LRU, mLSTM and sLSTM scans (``models/recurrent.py``)
  loop over time in Python, a few dozen ops a step. A loop longer than 3
  steps runs at 1, 2 and 3 steps on empty inputs of the call's layouts,
  and its bytes and FLOPs, forward and backward, are extrapolated to its
  length along the quadratic through them (``_Trip``), as the reference's
  cost model multiplies a ``while`` loop's body by its trip count. This is
  exact: each step runs the same ops on the same shapes, and the
  backward's cost grows with the length (each step's ``select`` backward
  writes a whole-sequence gradient). Its outputs and gradients are empty
  tensors of the real shapes. The peak holds the short loops' tensors
  and, during the backward, one allocation of the saved bytes the real
  loop adds, so there it is approximate (within 15% of the whole loop's
  on the tests' reduced models).
- **Rank shapes.** The step runs at the rank's batch: the global batch ÷ the
  dp size when ``batch_specs`` shards it, otherwise the whole batch, and at
  the model's full widths. A decode step writes and reads at position
  ``seq_len - 1`` (a step at full context; the cache is read whole at any
  position).
- **Per-chip FLOPs, bytes and temporaries** of a serve cell are the
  trace's divided by the model-axis size: the ideal TP split (``trace``
  keeps the undivided numbers). ``temp_size`` is the peak of the bytes the
  step creates (its outputs among them); arguments are not in it.
- **Train cells** trace one microbatch (the rank's rows of
  ``global_batch / accum_steps``) through the port's step at
  ``accum_steps = 1``. Its forward, remat recompute and backward are
  multiplied by ``accum_steps`` and divided by the model-axis size, as a
  serve cell's. The trace holds every gradient whole, which a rank of an
  FSDP mesh does not, so the rank's peak (``rank_peak``) replays the
  trace's storages with a divisor each (:class:`_GradShapes`): a storage
  the backward makes in a parameter leaf's shape (or one layer's of a
  stacked leaf) is that leaf's gradient, over its spec's split (data ×
  model where FSDP shards it); every other storage over the model-axis
  size. The optimizer update (``adamw_update``) is traced again on one
  rank's shards of the params, gradients and moments (``rank_update``),
  counted once a step: its FLOPs and bytes are the rank's, and its
  temporaries sit on top of what the replay holds when it starts.
  ``temp_size`` is the larger of the replay's peak and that sum, plus,
  when ``accum_steps > 1``, the f32 gradient sum the step keeps across
  microbatches (4 bytes a parameter, over its leaf's split). ``trace``
  keeps the undivided numbers of the whole step at the rank's rows. On a
  1 × 1 mesh every divisor is 1 and ``temp_size`` is the trace's peak.
- **Collectives** come from the rules, not from a trace (``collectives_of``),
  per rank, in the reference's layout ``{kind: {count, bytes,
  wire_bytes}}``: ``bytes`` the result buffer's, ``wire_bytes`` times the
  ring factor of the kind (all-reduce 2(n-1)/n, all-gather and
  reduce-scatter (n-1)/n):

  * TP over ``model`` (n = its size > 1): per forward one all-reduce of the
    rank's ``(B, S, d_model)`` activations (compute dtype) after each
    row-parallel output projection (an attention block's ``wo`` and its
    MLP's ``w_down`` or MoE combine, RG-LRU's ``w_out`` and ``w_down``,
    mLSTM's ``w_down``, sLSTM's ``w_out``: 2L + 1 with the next item for a
    dense model, the census ``parallel/ctx.py`` counts), and one all-gather
    of the f32 logits. Train adds remat's recompute (the same all-reduces
    again) and the backward's conjugates (one all-reduce a forward
    all-reduce, and one for the LM head's input gradient), per microbatch.
  * FSDP over ``data`` (train only): one all-gather of each fsdp-sharded
    leaf (its model shard) per forward and, for the stacked layers, per
    recompute, and one reduce-scatter of its gradient (param dtype) per
    microbatch; a leaf the rules leave whole over ``data`` has its
    gradient all-reduced over ``data`` per microbatch instead.
  * Across ``pod`` (train only): one all-reduce of each leaf's gradient
    shard per step.

  The ``"dh"`` cache layout's per-layer score partial sums are not
  counted (the port's TP forward splits heads).
- ``roofline`` and ``roofline_kernel_adjusted`` are left out: they need the
  H100's constants (``analysis/roofline.py``, not ported yet).
  ``model_flops`` is ``6·N·T`` (train) or ``2·N·T``, N the active
  non-embedding parameters, T the step's tokens.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels.ops import impl_mode
from repro_torch.launch.mesh import production_axes
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import (
    MeshAxes,
    Spec,
    batch_specs,
    cache_specs,
    logits_spec,
    param_specs,
    qt_specs_like,
)
from repro_torch.quant import QuantPolicy, quantized_structs
from repro_torch.train import step as step_mod
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.utils import row_tiles, tree_get, tree_map_with_path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n, "all-gather": lambda n: (n - 1) / n,
         "reduce-scatter": lambda n: (n - 1) / n}
# row-parallel output projections a block's forward ends with, each one TP all-reduce
_ROW_PARALLEL = {"attn": 2, "local_attn": 2, "cross": 2, "attn_moe": 2, "rglru": 2, "mlstm": 1, "slstm": 1}


class SkipCell(Exception):
    pass


# ---------------------------------------------------------------------------
# trees of meta tensors, QuantizedTensor planes and AdamW state
# ---------------------------------------------------------------------------


def _tensors(tree):
    """Every tensor of ``tree``, in order: dict values, sequence items, a
    QuantizedTensor's planes, an AdamWState's ``step``, ``m`` and ``v``."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, QuantizedTensor):
        yield tree.packed
        yield tree.scales
    elif isinstance(tree, AdamWState):
        yield from _tensors((tree.step, tree.m, tree.v))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _map(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)`` (containers as
    :func:`_tensors` walks them)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, QuantizedTensor):
        return tree.replace(packed=fn(tree.packed), scales=fn(tree.scales))
    if isinstance(tree, AdamWState):
        return AdamWState(step=fn(tree.step), m=_map(fn, tree.m), v=_map(fn, tree.v))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _pairs(tree, specs, ax: MeshAxes):
    """(tensor, spec) of every tensor of ``tree`` against the dense spec tree
    ``specs``; a QuantizedTensor's planes take :func:`qt_specs_like`'s."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, QuantizedTensor):
        qs = qt_specs_like(specs, tree, ax)
        yield tree.packed, qs.packed
        yield tree.scales, qs.scales
    elif isinstance(tree, AdamWState):
        yield from _pairs((tree.step, tree.m, tree.v), (specs.step, specs.m, specs.v), ax)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k], ax)
    elif isinstance(tree, (tuple, list)):
        for v, s in zip(tree, specs, strict=True):
            yield from _pairs(v, s, ax)


def split_of(spec: Spec, ax: MeshAxes) -> int:
    """How many ways ``spec`` splits its tensor: the product of its axes' sizes."""
    return math.prod(ax.size(a) for a in spec if a is not None)


def rank_bytes(tree, specs, ax: MeshAxes) -> int:
    """One rank's bytes of ``tree`` under ``specs``: each tensor's bytes over
    the product of its spec's axis sizes (exact: the rules keep only axes
    that divide)."""
    total = 0
    for t, spec in _pairs(tree, specs, ax):
        n, split = t.numel() * t.element_size(), split_of(spec, ax)
        if n % split:
            raise ValueError(f"{tuple(t.shape)} under {spec} does not split evenly")
        total += n // split
    return total


# ---------------------------------------------------------------------------
# input specs (meta stand-ins; no allocation)
# ---------------------------------------------------------------------------


def batch_structs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    meta = dict(device="meta")
    out = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = torch.empty((batch, seq), dtype=torch.int32, **meta)
    else:
        out["embeddings"] = torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16, **meta)
    out["labels"] = torch.empty((batch, seq), dtype=torch.int32, **meta)
    if cfg.family == "vlm":
        out["image_emb"] = torch.empty((batch, cfg.n_image_tokens, cfg.d_model), dtype=torch.bfloat16, **meta)
    return out


def param_structs(cfg: ModelConfig, quant: Optional[QuantPolicy]):
    structs = init_params(cfg, device="meta")
    if quant is not None:
        structs = quantized_structs(structs, quant)
    return structs


def _train_accum(sc: ShapeConfig, dp_size: int) -> int:
    """The reference's microbatch count: the most microbatches, up to 16,
    that split the global batch evenly, each microbatch evenly over dp."""
    accum = max(1, min(16, sc.global_batch // dp_size))
    while sc.global_batch % accum or (sc.global_batch // accum) % dp_size:
        accum -= 1
    return accum


def _cell_config(arch: Union[str, ModelConfig], kv_quant: bool) -> ModelConfig:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return dataclasses.replace(cfg, kv_cache_dtype="int8", stages=None) if kv_quant else cfg


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(
    arch: Union[str, ModelConfig],
    shape: Union[str, ShapeConfig],
    quant_q: int = 0,
    dp_size: int = 16,
    kv_quant: bool = False,
    *,
    accum: Optional[int] = None,
):
    """→ (step_fn, arg_structs, spec_fn, p_structs, meta) for one cell.

    ``quant_q``: 0 = dense bf16; 2 / 4 = group-wise BCQ with g = 128 on the
    serve paths. ``arch`` and ``shape`` may be a config and a shape set in
    place of their names (the card's own shapes), ``accum`` a train cell's
    microbatch count in place of the reference's search."""
    cfg, sc = _cell_config(arch, kv_quant), _shape(shape)
    if sc.name == "long_500k" and not cfg.supports_long_context:
        raise SkipCell(f"{cfg.name} is pure full-attention; long_500k skipped")

    policy = QuantPolicy(q=quant_q, g=128) if quant_q else None
    p_structs = param_structs(cfg, policy)
    serve_axes = lambda ax: dataclasses.replace(ax, fsdp=None)  # noqa: E731

    if sc.kind == "train":
        accum = accum or _train_accum(sc, dp_size)
        step = step_mod.make_train_step(cfg, remat=True, accum_steps=1)
        args = (p_structs, adamw_init(p_structs), batch_structs(cfg, sc.global_batch, sc.seq_len))

        def spec_fn(ax):
            ps = param_specs(cfg, ax)
            opt_specs = AdamWState(step=Spec(), m=ps, v=ps)
            bs = batch_specs(cfg, ax, sc.global_batch)
            metrics_specs = {"loss": Spec(), "moe_aux": Spec(), "grad_norm": Spec()}
            return (ps, opt_specs, bs), (ps, opt_specs, metrics_specs)

        tokens = sc.global_batch * sc.seq_len
        training = True
    elif sc.kind == "prefill":
        # serving: no FSDP on weights; DP replicas hold full TP-sharded
        # weights (BCQ makes them small; re-gathering them every step over
        # `data` is pure overhead)
        step = step_mod.make_prefill_step(cfg)
        b_structs = batch_structs(cfg, sc.global_batch, sc.seq_len)
        b_structs.pop("labels")
        args = (p_structs, b_structs, init_cache(cfg, sc.global_batch, sc.seq_len, device="meta"))

        def spec_fn(ax):
            ps = param_specs(cfg, serve_axes(ax))
            bs = batch_specs(cfg, ax, sc.global_batch)
            bs.pop("labels")
            cs = cache_specs(cfg, ax, sc.global_batch)
            return (ps, bs, cs), (logits_spec(cfg, ax, sc.global_batch), cs)

        tokens = sc.global_batch * sc.seq_len
        training = False
    else:  # decode: the position is a Python int (``utils.host_pos``), not an argument's bytes
        step = step_mod.make_serve_step(cfg)
        b_structs = batch_structs(cfg, sc.global_batch, 1)
        b_structs.pop("labels")
        args = (p_structs, init_cache(cfg, sc.global_batch, sc.seq_len, device="meta"), b_structs)

        def spec_fn(ax):
            ps = param_specs(cfg, serve_axes(ax))
            bs = batch_specs(cfg, ax, sc.global_batch)
            bs.pop("labels")
            cs = cache_specs(cfg, ax, sc.global_batch)
            return (ps, cs, bs), (logits_spec(cfg, ax, sc.global_batch), cs)

        tokens = sc.global_batch
        training = False

    counts = count_params(cfg, p_structs)
    meta = {
        "arch": arch if isinstance(arch, str) else cfg.name,
        "shape": sc.name,
        "kind": sc.kind,
        "tokens_per_step": tokens,
        "training": training,
        "quant_q": quant_q,
        "accum_steps": accum if sc.kind == "train" else 1,
        "params_total": counts["total"],
        "params_active": counts["active_nonembed"],
        "embed_params": counts["embed"],
    }
    return step, args, spec_fn, p_structs, meta


def _leaf_paths(tree) -> list:
    """(path, leaf) of every parameter leaf (a QuantizedTensor is one)."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def count_params(cfg: ModelConfig, p_structs) -> dict:
    """Exact logical param counts from the struct tree (QT leaves count their
    dense k·o size). active = total with MoE experts scaled by top_k/E."""
    total = active = embed = 0
    for keys, leaf in _leaf_paths(p_structs):
        if isinstance(leaf, QuantizedTensor):
            lead = math.prod(leaf.packed.shape[:-3])
            n = lead * leaf.k * leaf.o
        else:
            n = leaf.numel()
        total += n
        if keys and keys[0] == "embed":
            embed += n
            continue
        is_expert = (
            cfg.n_experts > 0
            and "mlp" in keys
            and keys[-1] in ("w_gate", "w_up", "w_down")
            and "shared" not in keys
        )
        if is_expert:
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n
    return {"total": total, "active_nonembed": active, "embed": embed}


def bcq_hbm_adjustment(p_structs) -> int:
    """Bytes the packed kernels do NOT move but the plain route the trace
    takes does: the dequantized f32 weight's round trip (write + read, 8·k·o)
    and the unpacked int8 signs' round trip (2·q·k·o) per quantized matmul
    use."""
    adj = 0
    for leaf in (x for _, x in _leaf_paths(p_structs)):
        if isinstance(leaf, QuantizedTensor):
            lead = math.prod(leaf.packed.shape[:-3])
            q = leaf.packed.shape[-3]
            ko = leaf.k * leaf.o
            adj += lead * (8 * ko + 2 * q * ko)
    return adj


def model_flops_estimate(n_params_active: int, tokens: int, training: bool) -> float:
    """6·N·D for a train step (fwd+bwd); 2·N·D for inference-only steps."""
    per_tok = 6 if training else 2
    return float(per_tok) * n_params_active * tokens


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class StepTracker(TorchDispatchMode):
    """Per op on meta tensors (the step's), the bytes of its distinct tensor
    inputs and outputs (``bytes``); the live bytes of the storages made
    since the tracker was entered, from the op that makes each until it is freed (``live``), and
    their peak (``peak``). Storages passed to :meth:`adopt` (the step's
    arguments) are never counted. ``flops`` is the ``FlopCounterMode`` the
    trace runs in; :meth:`total_flops` adds the FLOPs extrapolated beside
    it (``extra_flops``). Given ``classify`` (an op's output tensor → a
    class id), every storage made and freed is also logged as ``(class,
    ±bytes)`` in ``events``, which :func:`_rank_peak` replays with a divisor
    a class."""

    def __init__(self, flops: FlopCounterMode, classify=None):
        super().__init__()
        self.flops = flops
        self.extra_flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self.classify = classify
        self.events = []

    def _free(self, n: int, c: Optional[int] = None) -> None:
        self.live -= n
        if c is not None:
            self.events.append((c, -n))

    def total_flops(self) -> int:
        return self.flops.get_total_flops() + self.extra_flops

    def adopt(self, tree) -> None:
        for t in _tensors(tree):
            self._seen[t.untyped_storage()] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if not any(t.is_meta for t in ins + outs):  # host arithmetic on real tensors (a cached scale)
            return out
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                n = st.nbytes()
                self._seen[st] = n
                self.live += n
                c = None if self.classify is None else self.classify(t)
                if c is not None:
                    self.events.append((c, n))
                weakref.finalize(st, self._free, n, c)
        self.peak = max(self.peak, self.live)
        writes = func._schema.is_mutable
        moves = not (
            func.is_view
            or (not writes and all(id(t.untyped_storage()) in in_storages for t in outs))
            or func._overloadpacket.__name__.startswith(("empty", "new_empty"))
        )
        if moves:
            seen = set()
            for t in ins + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
        return out


# The plain scans' time loops (``models/recurrent.py``): name → the positional
# arguments whose tensors carry time on dim 1
_SCANS = {"rglru_scan_plain": (0, 1), "mlstm_scan_plain": (0, 1, 2, 3, 4), "slstm_scan_plain": (0,)}
TRIP_STEPS = (1, 2, 3)


def _at_length(values, s: int):
    """The quadratic through ``(k, values[i])`` for k in ``TRIP_STEPS``, at ``s``."""
    y1, y2, y3 = values
    return y1 + (s - 1) * (y2 - y1) + (s - 1) * (s - 2) // 2 * (y3 - 2 * y2 + y1)


@dataclasses.dataclass(frozen=True)
class _Like:
    """A tensor argument's layout: an empty tensor like it is made at each use."""

    shape: tuple
    stride: tuple
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool
    time: bool

    def make(self, k: Optional[int] = None) -> torch.Tensor:
        shape = (self.shape[0], k, *self.shape[2:]) if (self.time and k is not None) else self.shape
        t = torch.empty_strided(shape, self.stride, dtype=self.dtype, device=self.device)
        return t.requires_grad_(self.requires_grad)


def _likes(tree, time: bool):
    if isinstance(tree, torch.Tensor):
        return _Like(tuple(tree.shape), tree.stride(), tree.dtype, tree.device, tree.requires_grad, time)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_likes(v, time) for v in tree)
    return tree


def _made(tree, k: int, leaves: list):
    """``tree`` with each :class:`_Like` made at ``k`` steps; the ones that
    take gradients are appended to ``leaves``."""
    if isinstance(tree, _Like):
        t = tree.make(k)
        if tree.requires_grad:
            leaves.append(t)
        return t
    if isinstance(tree, (tuple, list)):
        return type(tree)(_made(v, k, leaves) for v in tree)
    return tree


class _Trip:
    """One call of a plain scan, its loop run at ``TRIP_STEPS`` steps on
    empty inputs of the call's layouts: the tracker's bytes and FLOPs,
    forward and backward, are extrapolated to the call's length (module
    docstring, Scans), and its outputs and gradients are empty tensors of
    the real shapes. The backward runs its short loops again with their
    saved tensors (outside any remat hooks) and holds, while it runs, one
    allocation of the saved bytes the real loop adds beyond them. No tensor
    of the call is kept between forward and backward."""

    def __init__(self, fn, time_pos, args, kwargs, tracker):
        self.fn, self.kwargs, self.tracker = fn, kwargs, tracker
        self.args = tuple(_likes(a, i in time_pos) for i, a in enumerate(args))
        self.length = next(_tensors(args[time_pos[0]])).shape[1]
        self.diff = [_likes(t, False) for t in _tensors(args) if t.requires_grad]

    def _runs(self):
        """Each short loop → (counts (flops, bytes), bytes it kept alive,
        its leaves that take gradients, its output)."""
        tr = self.tracker
        for k in TRIP_STEPS:
            leaves = []
            args = _made(self.args, k, leaves)
            f0, b0, l0 = tr.total_flops(), tr.bytes, tr.live
            out = self.fn(*args, **self.kwargs)
            yield (tr.total_flops() - f0, tr.bytes - b0), tr.live - l0, leaves, out

    def _extrapolate(self, counts) -> None:
        tr, s = self.tracker, self.length
        tr.extra_flops += _at_length([f for f, _ in counts], s) - sum(f for f, _ in counts)
        tr.bytes += _at_length([b for _, b in counts], s) - sum(b for _, b in counts)

    def forward(self):
        with torch.no_grad():
            runs = list(self._runs())
        self._extrapolate([c for c, _, _, _ in runs])
        # an output whose dim 1 follows the steps is the whole sequence's
        outs = [list(_tensors(out)) for _, _, _, out in runs]
        self.template = runs[-1][3]
        return tuple(
            torch.empty((t.shape[0], self.length, *t.shape[2:]) if t.dim() > 1 and t.shape[1] != u.shape[1]
                        else t.shape, dtype=t.dtype, device=t.device)
            for t, u in zip(outs[-1], outs[0]))

    def backward(self, used):
        """``used``: whether each output took a gradient."""
        tr = self.tracker
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
            runs = list(self._runs())
            for (f, b), _, _, _ in runs:  # rebuilding the graphs is not the step's work
                tr.extra_flops -= f
                tr.bytes -= b
            kept = [n for _, n, _, _ in runs]
            phantom = torch.empty((max(_at_length(kept, self.length) - sum(kept), 0),), dtype=torch.uint8,
                                  device="meta")
            counts = []
            for _, _, leaves, out in runs:
                outs = [t for t, u in zip(_tensors(out), used) if u and t.requires_grad]
                f0, b0 = tr.total_flops(), tr.bytes
                torch.autograd.grad(outs, leaves, [torch.empty_like(t) for t in outs], allow_unused=True)
                counts.append((tr.total_flops() - f0, tr.bytes - b0))
        del runs, phantom
        self._extrapolate(counts)
        return tuple(like.make() for like in self.diff)


class _TripScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trip, *diff):
        ctx.trip = trip
        ctx.set_materialize_grads(False)
        return trip.forward()

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.trip.backward([g is not None for g in grads]))


def _trip_aware(fn, time_pos, tracker):
    """``fn`` (a plain scan) traced by :class:`_Trip` when its loop is longer
    than ``TRIP_STEPS``."""

    def run(*args, **kwargs):
        first = next(_tensors(args[time_pos[0]]))
        if first.shape[1] <= TRIP_STEPS[-1] or kwargs.get("steps") is not None:
            return fn(*args, **kwargs)
        trip = _Trip(fn, time_pos, args, kwargs, tracker)
        outs = iter(_TripScan.apply(trip, *(t for t in _tensors(args) if t.requires_grad)))
        return _map(lambda _: next(outs), trip.template)

    return run


def trace_step(step, args, *, sections=(), classify=None, patches=()):
    """Run ``step(*args)`` once on meta tensors of ``args``' shapes under
    ``impl_mode("ref")`` and ``row_tiles()`` → {"flops", "bytes",
    "peak_bytes", "outputs", "sections"}: FLOPs by ``FlopCounterMode``, op
    bytes and the peak of the bytes the step creates by
    :class:`StepTracker`, the plain scans' loops extrapolated from a few
    steps (:class:`_Trip`). ``sections`` names ``(module, attribute)``
    functions whose calls are counted apart as well (``sections[name] =
    {"flops", "bytes", "calls"}``), e.g. the optimizer update of a train
    step; ``events_at`` the length of the event log at its first call).
    ``classify`` is :class:`StepTracker`'s, ``patches`` more ``(module,
    attribute, function)`` to run in place of the module's."""
    from repro_torch.models import recurrent

    fargs = _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), args)
    tracker = StepTracker(FlopCounterMode(display=False), classify)
    tracker.adopt(fargs)
    parts = {attr: {"flops": 0, "bytes": 0, "calls": 0} for _, attr in sections}

    def counted(attr, fn):
        def run(*a, **kw):
            f0, b0 = tracker.total_flops(), tracker.bytes
            parts[attr].setdefault("events_at", len(tracker.events))
            out = fn(*a, **kw)
            parts[attr]["flops"] += tracker.total_flops() - f0
            parts[attr]["bytes"] += tracker.bytes - b0
            parts[attr]["calls"] += 1
            return out

        return run

    patches = [*patches, *((mod, attr, counted(attr, getattr(mod, attr))) for mod, attr in sections)]
    patches += [(recurrent, name, _trip_aware(getattr(recurrent, name), pos, tracker)) for name, pos in _SCANS.items()]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        with tracker.flops, tracker, impl_mode("ref"), row_tiles():
            out = step(*fargs)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return {"flops": tracker.total_flops(), "bytes": tracker.bytes, "peak_bytes": tracker.peak,
            "outputs": _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), out),
            "sections": parts, "events": tracker.events}


# ---------------------------------------------------------------------------
# collectives, by rule
# ---------------------------------------------------------------------------


def _add(coll: dict, kind: str, n: int, nbytes: float, count: float = 1) -> None:
    if n <= 1 or count == 0:
        return
    c = coll[kind]
    c["count"] += count
    c["bytes"] += count * nbytes
    c["wire_bytes"] += count * nbytes * _RING[kind](n)


def collectives_of(cfg: ModelConfig, ax: MeshAxes, kind: str, rows: int, seq: int, logit_rows: int,
                   accum: int, p_structs=None, p_specs=None) -> dict:
    """One rank's collectives of a step by the module docstring's rules:
    ``rows`` the rank's batch rows (a microbatch's for train), ``seq`` the
    tokens a row, ``logit_rows`` the logits a row (``seq`` for train, 1 for
    the serve steps' last-position logits)."""
    coll = {k: {"count": 0, "bytes": 0, "wire_bytes": 0.0} for k in COLLECTIVE_KINDS}
    n_tp = ax.model_size
    act = rows * seq * cfg.d_model * torch.empty((), dtype=cfg.cdtype).element_size()
    logits = rows * logit_rows * cfg.vocab * 4
    n_ar = sum(_ROW_PARALLEL[b] * repeat for pattern, repeat in cfg.stages for b in pattern)
    # forward: an all-reduce after each row-parallel projection, the logits gathered
    _add(coll, "all-reduce", n_tp, act, n_ar * accum)
    _add(coll, "all-gather", n_tp, logits, accum)
    if kind != "train":
        return coll
    # remat's recompute of the stacked layers, the backward's conjugates and the LM head's input gradient
    _add(coll, "all-reduce", n_tp, act, (2 * n_ar + 1) * accum)
    f, n_f = ax.fsdp, ax.size(ax.fsdp)
    pods = ax.size("pod") if "pod" in dict(ax.sizes) else 1
    for path, leaf in _leaf_paths(p_structs):
        spec = tree_get(p_specs, path)
        for t, s in _pairs(leaf, spec, ax):
            nbytes = t.numel() * t.element_size()
            shard = nbytes // split_of(s, ax)
            if f is not None and f in tuple(s):
                gathered = shard * n_f  # the leaf's model shard, whole over `data`
                _add(coll, "all-gather", n_f, gathered, (2 if path[0] == "stages" else 1) * accum)
                _add(coll, "reduce-scatter", n_f, shard, accum)
            else:
                _add(coll, "all-reduce", n_f, shard, accum)
            _add(coll, "all-reduce", pods, shard, 1)
    return coll


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


ARG_NAMES = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch", "cache"),
             "decode": ("params", "cache", "batch")}


def argument_parts(kind: str, args, in_specs, ax: MeshAxes) -> dict:
    """One rank's bytes of each argument of a ``kind`` step (``ARG_NAMES``)."""
    return {name: rank_bytes(a, s, ax) for name, a, s in zip(ARG_NAMES[kind], args, in_specs, strict=True)}


def _rank_rows(global_rows: int, spec: Spec, ax: MeshAxes) -> int:
    return global_rows // split_of(Spec(spec[0]), ax)


def _rank_tree(tree, rows: int, dim: int):
    """Meta tensors of ``tree``'s shapes with dim ``dim`` (the batch) ``rows``."""
    return _map(lambda t: torch.empty((*t.shape[:dim], rows, *t.shape[dim + 1:]), dtype=t.dtype,
                                      device="meta"), tree)


def _with_repeats(cfg: ModelConfig, repeats) -> ModelConfig:
    """``cfg`` with each stage repeated ``repeats[i]`` times."""
    stages = tuple((pattern, r) for (pattern, _), r in zip(cfg.stages, repeats, strict=True))
    return dataclasses.replace(cfg, stages=stages, n_layers=sum(len(p) * r for p, r in stages))


_TRACED = ("flops", "bytes", "update_flops", "update_bytes", "peak_bytes")


def _squeezed(shape) -> tuple:
    """``shape`` without its dims of size 1 (a norm's gradient is made as
    ``(1, 1, d)`` and viewed as ``(d,)``)."""
    return tuple(d for d in shape if d != 1)


class _GradShapes:
    """The classes of a train step's storages (:class:`StepTracker`'s
    ``classify``): a storage made after the loss (in the backward) whose
    shape is a parameter leaf's, or one layer's of a stacked leaf (dims of
    size 1 aside), is a gradient, a class of its own a shape; every other
    storage is class 0, an activation. :meth:`divisors` says how many ways a
    mesh splits each."""

    def __init__(self, p_structs):
        self.backward = False
        self.ids = {}
        self.leaves = [()]  # class → ((path, per-layer), ...) of the leaves of its shape
        for path, leaf in _leaf_paths(p_structs):
            for per_layer in (False, True) if path[0] == "stages" else (False,):
                shape = _squeezed(leaf.shape[1:] if per_layer else leaf.shape)
                c = self.ids.setdefault(shape, len(self.leaves))
                if c == len(self.leaves):
                    self.leaves.append(())
                self.leaves[c] += ((path, per_layer),)

    def start_backward(self) -> None:
        self.backward = True

    def __call__(self, t: torch.Tensor) -> int:
        return self.ids.get(_squeezed(t.shape), 0) if self.backward else 0

    def divisors(self, p_specs, ax: MeshAxes) -> list:
        """Class → its split on ``ax``: an activation the model axis's size,
        a gradient its leaf's spec's (the smallest, where leaves share the
        shape)."""
        return [ax.model_size] + [
            min(split_of(Spec(*tuple(tree_get(p_specs, path))[1 if per_layer else 0:]), ax)
                for path, per_layer in leaves)
            for leaves in self.leaves[1:]
        ]


def _after(fn, then):
    """``fn`` that calls ``then()`` when it returns."""

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        then()
        return out

    return run


def _trace_at(cfg: ModelConfig, sc: ShapeConfig, quant_q: int, rows: int) -> dict:
    """One trace of ``cfg``'s step at the rank's ``rows`` (a microbatch's for
    train) → the ``_TRACED`` numbers and the traced outputs; for train also
    the storages' event log up to the update (``events``) and their classes
    (``grad_shapes``)."""
    step, args, _, _, _ = input_specs(cfg, sc, quant_q, accum=1)
    sections, extra = (), {}
    if sc.kind == "train":
        trace_args, run = (args[0], args[1], _rank_tree(args[2], rows, 0)), step
        sections = ((step_mod, "adamw_update"),)
        shapes = _GradShapes(args[0])
        extra = dict(classify=shapes, patches=((step_mod, "loss_fn", _after(step_mod.loss_fn, shapes.start_backward)),))
    elif sc.kind == "prefill":
        trace_args, run = (args[0], _rank_tree(args[1], rows, 0), _rank_tree(args[2], rows, 1)), step
    else:
        pos = sc.seq_len - 1
        trace_args = (args[0], _rank_tree(args[1], rows, 1), _rank_tree(args[2], rows, 0))
        run = lambda p, c, b: step(p, c, b, pos)  # noqa: E731
    tr = trace_step(run, trace_args, sections=sections, **extra)
    upd = tr["sections"].get("adamw_update", {"flops": 0, "bytes": 0})
    out = {"flops": tr["flops"] - upd["flops"], "bytes": tr["bytes"] - upd["bytes"],
           "update_flops": upd["flops"], "update_bytes": upd["bytes"], "peak_bytes": tr["peak_bytes"],
           "outputs": tr["outputs"]}
    if sc.kind == "train":
        out.update(events=tr["events"][:upd["events_at"]], grad_shapes=extra["classify"])
    return out


def _shards(tree, specs, ax: MeshAxes):
    """Meta tensors of one rank's shards of the dense tensors of ``tree``
    under ``specs``: each dim over the sizes of its spec's axes."""
    if isinstance(tree, torch.Tensor):
        shape = [d // ax.size(a) for d, a in zip(tree.shape, (*specs, *(None,) * tree.dim()))]
        return torch.empty(shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, AdamWState):
        return AdamWState(step=_shards(tree.step, specs.step, ax), m=_shards(tree.m, specs.m, ax),
                          v=_shards(tree.v, specs.v, ax))
    if isinstance(tree, dict):
        return {k: _shards(v, specs[k], ax) for k, v in tree.items()}
    return type(tree)(_shards(v, sp, ax) for v, sp in zip(tree, specs, strict=True))


def rank_update(params, opt: AdamWState, p_specs, opt_specs, ax: MeshAxes) -> dict:
    """``adamw_update`` traced on one rank's shards of the params, their
    gradients (the params' shapes and dtypes) and the moments → its FLOPs,
    bytes and the peak of its temporaries (the update is elementwise but for
    the global norm, a scalar all-reduced across ranks)."""
    p, o = _shards(params, p_specs, ax), _shards(opt, opt_specs, ax)
    update = lambda g, o, p: step_mod.adamw_update(g, o, p, lr=3e-4)  # noqa: E731  (no value is read)
    tr = trace_step(update, (_map(torch.empty_like, p), o, p))
    return {"flops": tr["flops"], "bytes": tr["bytes"], "peak_bytes": tr["peak_bytes"]}


def _rank_peak(tr: dict, divisors: list, update_peak: int) -> dict:
    """Replays a train trace's event log with each class's bytes over its
    divisor → one rank's peak of the forward and backward, its live bytes
    when the update starts (its gradients among them) and the step's peak,
    the larger of the first and the second plus the update's temporaries."""
    live = peak = grads = 0.0
    for c, n in tr["events"]:
        live += n / divisors[c]
        grads += n / divisors[c] if c else 0
        peak = max(peak, live)
    return {"forward_backward": peak, "at_update": live, "gradients_at_update": grads,
            "update_temporaries": update_peak, "step": max(peak, live + update_peak)}


def _traced_whole(cfg: ModelConfig, sc: ShapeConfig) -> bool:
    """Whether :func:`trace_cell` traces every layer (module docstring, Depth)."""
    return sc.kind == "train" or all(r == 1 for _, r in cfg.stages)


@functools.lru_cache(maxsize=64)
def trace_cell(cfg: ModelConfig, sc: ShapeConfig, quant_q: int, rows: int) -> dict:
    """The step's ``_TRACED`` numbers at full depth and ``rows`` rank rows
    (a train step's: one microbatch's). A train step traces every layer; a
    serve step extrapolates each stage's repeats from traces at one and at
    two repeats (module docstring, Depth), which keeps a cell of a deep
    model to a few traced layers. Cached: cells that differ in their mesh
    alone share a trace (the numbers are per rank; the trace does not see
    the mesh)."""
    if _traced_whole(cfg, sc):
        return _trace_at(cfg, sc, quant_q, rows)
    ones = [1] * len(cfg.stages)
    base = _trace_at(_with_repeats(cfg, ones), sc, quant_q, rows)
    out = dict(base)
    for i, (_, repeat) in enumerate(cfg.stages):
        if repeat > 1:
            two = _trace_at(_with_repeats(cfg, ones[:i] + [2] + ones[i + 1:]), sc, quant_q, rows)
            for key in _TRACED:
                out[key] += (repeat - 1) * (two[key] - base[key])
    return out


def run_cell(
    arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig], mesh_kind: Union[str, MeshAxes],
    quant_q: int = 0, verbose: bool = True, kv_quant: bool = False, *, accum: Optional[int] = None,
) -> dict:
    """One cell's record (module docstring). ``mesh_kind`` is ``"single"``,
    ``"multi"`` or the axes of another mesh; ``arch`` / ``shape`` a name or
    a config; ``accum`` a train cell's microbatch count in place of the
    reference's search."""
    if isinstance(mesh_kind, MeshAxes):
        ax, mesh_name = mesh_kind, "x".join(str(s) for _, s in mesh_kind.sizes)
    else:
        ax, mesh_name = production_axes(multi_pod=mesh_kind == "multi"), mesh_kind
    _, args, spec_fn, p_structs, meta = input_specs(
        arch, shape, quant_q, dp_size=ax.data_size, kv_quant=kv_quant, accum=accum
    )
    cfg, sc = _cell_config(arch, kv_quant), _shape(shape)
    in_specs, out_specs = spec_fn(ax)
    names = ARG_NAMES[sc.kind]
    parts = argument_parts(sc.kind, args, in_specs, ax)
    A = meta["accum_steps"]
    batch = names.index("batch")
    first = next(iter(args[batch]))
    rows = _rank_rows(sc.global_batch // A, in_specs[batch][first], ax)

    t0 = time.time()
    tr = trace_cell(cfg, sc, quant_q, rows)
    t_trace = time.time() - t0
    n_tp = ax.model_size
    flops = tr["flops"] * A + tr["update_flops"]
    nbytes = tr["bytes"] * A + tr["update_bytes"]
    peak = tr["peak_bytes"]
    if sc.kind == "train":
        upd = rank_update(args[0], args[1], in_specs[0], in_specs[1], ax)
        rank_peak = _rank_peak(tr, tr["grad_shapes"].divisors(in_specs[0], ax), upd["peak_bytes"])
        if A > 1:  # the f32 gradient sum kept across microbatches
            peak += 4 * sum(t.numel() for t in _tensors(args[0]))
            rank_peak["gradient_sum"] = sum(4 * t.numel() // split_of(sp, ax) for t, sp in _pairs(args[0], in_specs[0], ax))
            rank_peak["step"] += rank_peak["gradient_sum"]
        rank = {"flops": tr["flops"] * A / n_tp + upd["flops"], "bytes": tr["bytes"] * A / n_tp + upd["bytes"],
                "temp": rank_peak["step"]}
    else:
        rank = {"flops": flops / n_tp, "bytes": nbytes / n_tp, "temp": peak / n_tp}
    if sc.kind == "train":  # the step updates params and moments in place and returns them
        outs = (args[0], args[1], tr["outputs"][2])
    else:
        logits = tr["outputs"][0]
        outs = (_rank_tree(logits, sc.global_batch, 0), args[names.index("cache")])
    output_size = rank_bytes(outs, out_specs, ax)
    seq = sc.seq_len if sc.kind != "decode" else 1
    coll = collectives_of(cfg, ax, sc.kind, rows, seq, sc.seq_len if sc.kind == "train" else 1, A, args[0],
                          in_specs[0] if sc.kind == "train" else None)
    coll_total = sum(c["bytes"] for c in coll.values())
    coll_wire = sum(c["wire_bytes"] for c in coll.values())
    mf = model_flops_estimate(meta["params_active"], meta["tokens_per_step"], meta["training"])
    adj = bcq_hbm_adjustment(p_structs) if quant_q else 0
    result = {
        "arch": meta["arch"],
        "shape": sc.name,
        "mesh": mesh_name,
        "chips": ax.ranks,
        "quant_q": quant_q,
        "lower_s": t_trace,
        "compile_s": 0.0,
        "memory_analysis": {
            "argument_size": sum(parts.values()),
            "output_size": output_size,
            "temp_size": rank["temp"],
            "generated_code_size": None,
        },
        "argument_parts": parts,
        "cost_analysis_builtin": {"flops": rank["flops"], "bytes": rank["bytes"]},
        "trip_aware": {"flops": rank["flops"], "bytes": rank["bytes"], "collectives": coll, "unparsed_loops": 0},
        "trace": {"flops": flops, "bytes": nbytes, "peak_bytes": peak, "model_size": n_tp, "rank_rows": rows,
                  "seq": seq, "accum_steps": A, "update_flops": tr["update_flops"],
                  "update_bytes": tr["update_bytes"], "whole": _traced_whole(cfg, sc),
                  "device": "meta, the GPU's row tiles"},
        **({"rank_update": upd, "rank_peak": rank_peak} if sc.kind == "train" else {}),
        "collectives": coll,
        "collective_bytes": coll_total,
        "collective_wire_bytes": coll_wire,
        "model_flops": mf,
        "bcq_hbm_adjustment": adj,
        "meta": meta,
    }
    if verbose:
        print(f"--- {meta['arch']} × {sc.name} × {mesh_name} (q={quant_q or 'dense'}) ---")
        print(f"per rank: arguments {sum(parts.values()) / 1e9:.3f} GB {parts}, outputs {output_size / 1e9:.3f} GB, "
              f"temporaries {rank['temp'] / 1e9:.3f} GB; flops {rank['flops']:.4g}, bytes {rank['bytes']:.4g}; "
              f"collectives {coll_total / 1e9:.3f} GB (wire {coll_wire / 1e9:.3f}); trace {t_trace:.1f}s")
    return result


def cell_list(mesh_kinds):
    """Assigned cells: train = bf16, serve = q4 (the system as the paper
    intends). Single-pod serve cells also get dense + q2 variants, the
    paper-comparison baselines."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, sc in SHAPES.items():
            if shape == "long_500k" and not cfg.supports_long_context:
                continue
            for mesh_kind in mesh_kinds:
                if sc.kind == "train":
                    cells.append((arch, shape, mesh_kind, 0))
                    continue
                quants = (4,) if mesh_kind == "multi" else (4, 2, 0)
                for q in quants:
                    cells.append((arch, shape, mesh_kind, q))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--quant", type=int, default=None, help="BCQ q bits (0=dense)")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    mesh_kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = cell_list(mesh_kinds)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        q = args.quant
        if q is None:
            q = 0 if SHAPES[args.shape].kind == "train" else 4
        cells = [(args.arch, args.shape, mk, q) for mk in mesh_kinds]

    os.makedirs(args.out_dir, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    t_all = time.time()
    for arch, shape, mesh_kind, q in cells:
        suffix = "__kvq8" if args.kv_quant else ""
        name = f"{arch}__{shape}__{mesh_kind}__q{q}{suffix}.json"
        path = os.path.join(args.out_dir, name)
        if os.path.exists(path) and not args.force:
            n_skip += 1
            continue
        try:
            res = run_cell(arch, shape, mesh_kind, q, verbose=False, kv_quant=args.kv_quant)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            n_ok += 1
            m = res["memory_analysis"]
            print(f"OK  {name}: arguments {m['argument_size'] / 1e9:.3f} GB, temporaries "
                  f"{m['temp_size'] / 1e9:.3f} GB, flops {res['cost_analysis_builtin']['flops']:.4g}, collectives "
                  f"{res['collective_bytes'] / 1e9:.3f} GB per rank; trace {res['lower_s']:.1f}s", flush=True)
        except SkipCell as e:
            print(f"SKIP {name}: {e}")
            n_skip += 1
        except Exception:
            print(f"FAIL {name}:")
            traceback.print_exc()
            n_fail += 1
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed in {time.time() - t_all:.1f}s")


if __name__ == "__main__":
    main()
