"""AdamW written out in tensor code (counterpart of
``repro/train/optimizer.py``; no optimizer library).

The reference's arithmetic, leaf by leaf: first and second moments are f32
whatever the parameter's dtype; the gradients are widened to f32, their
global norm ``sqrt(Σ g² + 1e-12)`` taken over every leaf and the clip
applied before the moments; the update is computed in f32 and cast back to
the parameter's dtype. Weight decay is decoupled and added to the step
(``p - lr·(m̂ / (sqrt(v̂) + eps) + wd·p)``), which is not
``torch.optim.AdamW``'s order (it decays the weight first) and which has no
global clip.

The state keeps the reference's field names, ``step``, ``m`` and ``v``, so a
checkpoint's keys are the same in both packages (``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.utils import tree_get, tree_leaves, tree_map, tree_map_with_path


# A leaf of more elements than this is updated in pieces of at most this
# many, whole rows of its first axis (a layer of a stacked leaf, a block
# of an embedding's rows): their f32 temporaries stay ~0.3 GB each
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # () int32
    m: Any  # tree like params (f32)
    v: Any  # tree like params (f32)


def adamw_init(params) -> AdamWState:
    """Zero moments in f32 beside each parameter, on its device; step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=tree_map(torch.clone, zeros))


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns (params, state, global_grad_norm), the norm taken before the
    clip. ``lr`` is a float or a 0-d tensor.

    The update is written in place: the new moments into ``state``'s
    tensors, the new parameters into ``params``' tensors, and those same
    objects are returned, so one copy of the parameters and the moments
    stays on the card (llama3.2-3b's 3.6 B parameters: 7.2 GB in bf16,
    28.9 GB of f32 moments). Leaf by leaf, in pieces of at most
    ``SLICE_ELEMS`` elements (whole rows), so the f32 temporaries are one
    piece's at a time; the arithmetic is elementwise, so the values are
    those of the whole leaf at once."""
    total = 0.0
    for g in tree_leaves(grads):
        gf = g.to(torch.float32)
        total = total + torch.sum(gf * gf)
    gnorm = torch.sqrt(total + 1e-12)
    scale = torch.clamp_max(grad_clip / gnorm, 1.0) if grad_clip else None

    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    def update(p, g, m, v):
        """The reference's arithmetic on a slice of one leaf → (new
        parameter in f32, new m, new v)."""
        dev = p.device
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale.to(dev)
        new_m = b1 * m + (1 - b1) * g
        new_v = b2 * v + (1 - b2) * g * g
        pf = p.to(torch.float32)
        new_p = pf - lr.to(dev) * (new_m / c1.to(dev) / (torch.sqrt(new_v / c2.to(dev)) + eps) + weight_decay * pf)
        return new_p, new_m, new_v

    def write(path, p):
        g, m, v = tree_get(grads, path), tree_get(state.m, path), tree_get(state.v, path)
        rows = max(1, SLICE_ELEMS // max(1, p[0].numel())) if p.dim() > 1 else p.shape[0] if p.dim() else 1
        for ps, gs, ms, vs in zip(*(t.split(rows) if t.dim() else (t,) for t in (p, g, m, v))):
            for dst, src in zip((ps, ms, vs), update(ps, gs, ms, vs)):
                dst.copy_(src)

    tree_map_with_path(write, params)
    state.step.copy_(step)
    return params, state, gnorm


def cosine_lr(step, *, peak: float, warmup: int, total: int) -> torch.Tensor:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to 0 at ``total``; f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * peak * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)
