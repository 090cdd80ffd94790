"""Inference engine: prefill / decode over packed weights."""

from repro_torch.infer.engine import Engine, GenerationResult

__all__ = ["Engine", "GenerationResult"]
