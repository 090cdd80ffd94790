"""Decoder models (every family of the reference: dense, MoE, vlm, audio, hybrid, ssm)."""

from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.fuse import fuse_decode_projections
from repro_torch.models.model import forward, init_cache, init_params, reset_cache

__all__ = [
    "ModelConfig",
    "forward",
    "fuse_decode_projections",
    "init_cache",
    "init_params",
    "opt_state_from_numpy",
    "params_from_numpy",
    "reduced",
    "reset_cache",
]
