"""Published model configs (counterpart of ``repro/configs``; every arch of
the reference: the dense decoders, the audio musicgen-medium, the MoE
olmoe-1b-7b and llama4-maverick-400b-a17b, the vlm llama-3.2-vision-90b,
the hybrid recurrentgemma-9b and the ssm xlstm-125m).

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
    "musicgen-medium": "musicgen_medium",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-125m": "xlstm_125m",
    "gpt3-175b": "gpt3_175b",  # the paper's own estimation target (§IV)
}

ARCH_IDS = tuple(k for k in _ARCHS if k != "gpt3-175b")


def get_config(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")
    return mod.CONFIG
