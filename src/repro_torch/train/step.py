"""Loss and the train / prefill / serve steps (counterpart of
``repro/train/step.py``).

``make_train_step`` returns one full step: forward (remat) → cross-entropy
plus the MoE load-balance loss → backward → AdamW. ``make_*_step`` return
closures over the config, as the reference's do.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import impl_mode
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWState, adamw_update
from repro_torch.utils import tree_get, tree_leaves, tree_map, tree_map_with_path

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; labels < 0 are masked. logits (B, S, V) f32, labels (B, S)."""
    mask = labels >= 0
    safe = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


def _inputs(cfg: ModelConfig, batch: dict) -> dict:
    """The forward's keyword inputs of a batch, by family: ``tokens`` or
    ``embeddings``, and a vlm model's ``image_emb``."""
    kwargs = {}
    if cfg.input_kind == "tokens":
        kwargs["tokens"] = batch["tokens"]
    else:
        kwargs["embeddings"] = batch["embeddings"]
    if cfg.family == "vlm":
        kwargs["image_emb"] = batch.get("image_emb")
    return kwargs


def loss_fn(cfg: ModelConfig, params, batch: dict, *, remat: bool = True):
    """→ (loss + ``MOE_AUX_WEIGHT`` · aux, {"loss", "moe_aux"})."""
    logits, _, aux = forward(cfg, params, **_inputs(cfg, batch), remat=remat, with_aux=True)
    loss = cross_entropy(logits, batch["labels"])
    total = loss + MOE_AUX_WEIGHT * aux
    return total, {"loss": loss, "moe_aux": aux}


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *, remat: bool = True):
    """(metrics, gradients in ``params``' tree) of :func:`loss_fn`, on the
    train step's route (``impl_mode("ref")``, :func:`make_train_step`); the
    counterpart of ``jax.value_and_grad(loss_fn, has_aux=True)``, the loss in
    ``metrics``. Gradients are taken through detached copies of the leaves,
    so the caller's tensors never come to require grad (a served model must
    not: the kernels refuse such inputs); a leaf the loss does not reach
    gets zeros, as in JAX."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with impl_mode("ref"):
        total, metrics = loss_fn(cfg, leaves, batch, remat=remat)
        grads = iter(torch.autograd.grad(total, tree_leaves(leaves), allow_unused=True, materialize_grads=True))
    return {k: v.detach() for k, v in metrics.items()}, tree_map(lambda _: next(grads), leaves)


def make_train_step(cfg: ModelConfig, *, remat: bool = True, lr: float = 3e-4, accum_steps: int = 1):
    """(params, opt_state, batch) → (params, opt_state, metrics).

    The step's route is a stated rule: its forward and backward run under
    ``impl_mode("ref")``, the reference's own training route: the plain
    attention (``_sdpa``, ``_sdpa_qchunked`` from 8192 tokens,
    ``_local_attention_chunked``), the mLSTM's parallel forms and the plain
    scans, none of which is a hand-written kernel (no kernel here or in the
    reference has a backward; each refuses a grad-requiring input,
    ``kernels/_common.py::forward_only``). Dense products are unaffected.

    ``accum_steps > 1`` splits the batch into that many microbatches along
    its first axis, sums their gradients in f32 and divides, and averages
    their metrics, as the reference's scan does: live activations scale
    with the microbatch. The update is written into ``params`` and
    ``opt_state`` in place (``adamw_update``), which are
    returned: one copy of the weights and moments on the card."""

    def train_step(params, opt_state: AdamWState, batch: dict):
        if accum_steps == 1:
            metrics, grads = loss_and_grads(cfg, params, batch, remat=remat)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])
                     for k, v in batch.items() if v is not None}
            gsum, ms = None, []
            for i in range(accum_steps):
                m, g = loss_and_grads(cfg, params, {k: v[i] for k, v in micro.items()}, remat=remat)
                gf = tree_map(lambda t: t.to(torch.float32), g)
                gsum = gf if gsum is None else tree_map_with_path(lambda path, a: a + tree_get(gf, path), gsum)
                ms.append(m)
            grads = tree_map(lambda t: t / accum_steps, gsum)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        new_params, new_opt, gnorm = adamw_update(grads, opt_state, params, lr=lr)
        return new_params, new_opt, dict(metrics, grad_norm=gnorm)

    return train_step


def make_prefill_step(cfg: ModelConfig, s_max: Optional[int] = None):
    """(params, batch, cache) → (last-position logits, filled cache)."""

    def prefill_step(params, batch: dict, cache):
        return forward(cfg, params, **_inputs(cfg, batch), cache=cache, pos=0, logits_mode="last")

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, batch, pos) → (logits (B, 1, V),
    cache): one new token against a filled cache or recurrent state, with
    weights that may be packed (the paper's generation stage). A vlm
    model's cross blocks attend the cached image memory."""

    def serve_step(params, cache, batch: dict, pos):
        kwargs = _inputs(cfg, batch)
        if cfg.family == "vlm":
            kwargs["image_emb"] = None
        return forward(cfg, params, **kwargs, cache=cache, pos=pos, logits_mode="last")

    return serve_step
