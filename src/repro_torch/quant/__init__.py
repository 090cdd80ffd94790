"""Model-level quantization policies."""

from repro_torch.quant.quantize import (
    QuantPolicy,
    quantize_params,
    quantized_bytes,
    truncate_params,
)

__all__ = ["QuantPolicy", "quantize_params", "quantized_bytes", "truncate_params"]
