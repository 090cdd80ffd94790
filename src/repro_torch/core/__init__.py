"""Core quantization math and the format registry."""

from repro_torch.core.bcq import (
    bcq_error,
    compression_ratio,
    dequantize,
    quantize_bcq,
    quantize_bcq_greedy,
)
from repro_torch.core.formats import (
    QuantFormat,
    format_names,
    get_format,
    register_format,
)
from repro_torch.core.packing import pack_codes, pack_signs, unpack_codes, unpack_signs
from repro_torch.core.qtensor import QuantizedTensor, fuse_tensors, quantize_tensor

__all__ = [
    "QuantFormat",
    "QuantizedTensor",
    "bcq_error",
    "compression_ratio",
    "dequantize",
    "format_names",
    "fuse_tensors",
    "get_format",
    "pack_codes",
    "pack_signs",
    "quantize_bcq",
    "quantize_bcq_greedy",
    "quantize_tensor",
    "register_format",
    "unpack_codes",
    "unpack_signs",
]
