"""Published model configs (counterpart of ``repro/configs``; the dense
decoders only, the family the port runs so far).

``get_config(arch_id)`` resolves the ``--arch`` flag. Each module defines
``CONFIG`` at the published shape; reduced variants come from
``repro_torch.models.config.reduced``.
"""

from __future__ import annotations

import importlib

_ARCHS = {
    "llama3.2-3b": "llama3_2_3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "minitron-4b": "minitron_4b",
    "starcoder2-7b": "starcoder2_7b",
    "gpt3-175b": "gpt3_175b",  # the paper's own estimation target (§IV)
}

ARCH_IDS = tuple(k for k in _ARCHS if k != "gpt3-175b")


def get_config(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; ported: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")
    return mod.CONFIG
