"""Carry parameters across from numpy into the port.

:func:`params_from_numpy` takes a parameter tree of numpy arrays in the
reference's keys and layer-stacked layout (nested dicts and tuples, as its
``init_params`` builds them) and returns the port's tree on ``device``.
A quantized leaf arrives as a plain dict ``{"packed", "scales", "g", "k",
"o", "fmt"}`` and becomes a :class:`QuantizedTensor`.

:func:`opt_state_from_numpy` carries an optimizer state across the same way:
the reference's ``AdamWState`` with numpy leaves (or any object, or dict,
with its ``step``, ``m`` and ``v``) becomes the port's
:class:`~repro_torch.train.optimizer.AdamWState`, its moments in the
parameters' tree.

bfloat16 arrays (numpy's ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses) are carried as their uint16 bit patterns and viewed as
``torch.bfloat16``, so the values cross bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.utils import resolve_device

_QT_KEYS = frozenset({"packed", "scales", "g", "k", "o", "fmt"})


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16))
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, *, device="cuda"):
    """Numpy parameter tree → the port's parameter tree on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict) and set(node) == _QT_KEYS:
            return QuantizedTensor(
                packed=tensor_from_numpy(node["packed"], dev),
                scales=tensor_from_numpy(node["scales"], dev),
                g=int(node["g"]),
                k=int(node["k"]),
                o=int(node["o"]),
                fmt=str(node["fmt"]),
            )
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(convert(v) for v in node)
        return tensor_from_numpy(node, dev)

    return convert(tree)


def opt_state_from_numpy(state, *, device="cuda"):
    """The reference's AdamW state with numpy leaves (``step``, and ``m`` /
    ``v`` trees in the parameters' layout) → the port's ``AdamWState`` on
    ``device``."""
    from repro_torch.train.optimizer import AdamWState

    get = state.__getitem__ if isinstance(state, dict) else lambda name: getattr(state, name)
    dev = resolve_device(device)
    return AdamWState(step=tensor_from_numpy(get("step"), dev).to(torch.int32),
                      m=params_from_numpy(get("m"), device=dev), v=params_from_numpy(get("v"), device=dev))
