"""Model-level quantization policies."""

from repro_torch.quant.quantize import (
    QuantPolicy,
    quantize_params,
    quantized_bytes,
    quantized_structs,
    truncate_params,
)

__all__ = ["QuantPolicy", "quantize_params", "quantized_bytes", "quantized_structs",
           "truncate_params"]
