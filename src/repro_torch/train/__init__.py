"""Training runtime: optimizer, steps, loop, checkpointing, compression
(counterpart of ``repro/train``)."""

from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.train.step import (
    cross_entropy,
    loss_and_grads,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "cross_entropy",
    "loss_and_grads",
    "loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]
