"""Decoder models (the dense family so far)."""

from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.fuse import fuse_decode_projections
from repro_torch.models.model import forward, init_cache, init_params

__all__ = [
    "ModelConfig",
    "forward",
    "fuse_decode_projections",
    "init_cache",
    "init_params",
    "params_from_numpy",
    "reduced",
]
