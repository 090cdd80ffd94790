"""QuantFormat — the quantization-format protocol and registry (counterpart of
``repro/core/formats.py``; only the ``bcq`` format is ported so far).

A format owns how a weight is packed, which kernels consume the packed form
and which capabilities (nested truncation, output-dim fusion) it supports.
Everything else reaches it through :func:`repro_torch.kernels.ops.qmatmul`.

Shared physical layout: ``packed (…, P, k//8, o)`` uint8 code planes and
``scales (…, S, k//g, o)`` group parameters.
"""

from __future__ import annotations

import abc
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core import bcq as bcq_lib
from repro_torch.core import packing
from repro_torch.core.qtensor import QuantizedTensor


def split_outputs(y: torch.Tensor, out_dims: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Split the last axis of ``y`` into consecutive pieces of ``out_dims``."""
    return tuple(torch.split(y, list(out_dims), dim=-1))


class QuantFormat(abc.ABC):
    """One quantization format: packing, kernels and capabilities.

    ``impls`` names the format's kernels in order of preference; ``auto``
    dispatch takes ``impls[0]`` on the GPU and the ``ref`` oracle on the CPU.
    """

    name: str
    impls: Tuple[str, ...] = ()
    supports_truncate: bool = False
    supports_fuse: bool = True

    @abc.abstractmethod
    def quantize(
        self,
        w: torch.Tensor,
        *,
        q: int,
        g: int,
        scale_dtype=torch.bfloat16,
        method: str = "alternating",
        iters: int = 8,
    ) -> QuantizedTensor:
        """Quantize and pack a dense 2-D ``(k, o)`` weight on its device."""

    @abc.abstractmethod
    def dequantize(self, qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
        """Reconstruct the dense ``(…, k, o)`` matrix."""

    @abc.abstractmethod
    def matvec(
        self, xb: torch.Tensor, qt: QuantizedTensor, *, impl: str, out_dims: Sequence[int]
    ) -> Tuple[torch.Tensor, ...]:
        """Kernel entry: ``(B, k) @ qt`` → the ``(B, o_i)`` f32 pieces of
        ``out_dims``, consuming the packed form through the kernel ``impl``."""

    def matmul(self, xb: torch.Tensor, qt: QuantizedTensor, *, dtype) -> torch.Tensor:
        """Oracle entry: dequantize into ``dtype`` and run one dense product
        accumulated in f32 → ``(B, o)`` f32."""
        w = self.dequantize(qt, dtype=dtype)
        return torch.matmul(xb.to(dtype).to(torch.float32), w.to(torch.float32))

    def resolve_impl(self, impl: str, x: torch.Tensor) -> str:
        """``auto`` → this format's preferred kernel for a tensor on the
        GPU, ``ref`` for a tensor on the CPU."""
        if impl == "auto":
            impl = self.impls[0] if (x.is_cuda and self.impls) else "ref"
        if impl != "ref" and impl not in self.impls:
            raise ValueError(
                f"format {self.name!r} has no kernel impl {impl!r}; "
                f"available: {('ref',) + tuple(self.impls)}"
            )
        return impl

    def nbytes(self, qt: QuantizedTensor) -> int:
        """Packed size in bytes (code planes + scales)."""
        return qt.packed.numel() + qt.scales.numel() * qt.scales.element_size()

    def truncate(self, qt: QuantizedTensor, q_new: int) -> QuantizedTensor:
        raise ValueError(
            f"format {self.name!r} does not support nested truncation "
            "(self-speculative drafts need a residual-nested format like 'bcq')"
        )

    def fuse(self, qts: Sequence[QuantizedTensor]) -> QuantizedTensor:
        """Concatenate N projections along the output dim."""
        if not self.supports_fuse:
            raise ValueError(f"format {self.name!r} does not support output-dim fusion")
        first = qts[0]
        for t in qts[1:]:
            if (t.k, t.q, t.g) != (first.k, first.q, first.g):
                raise ValueError(
                    f"cannot fuse: (k, q, g) mismatch {(t.k, t.q, t.g)} vs "
                    f"{(first.k, first.q, first.g)}"
                )
            if t.scales.dtype != first.scales.dtype:
                raise ValueError("cannot fuse: scale dtype mismatch")
            if t.packed.shape[:-1] != first.packed.shape[:-1]:
                raise ValueError("cannot fuse: leading (layer/expert) dims differ")
        return QuantizedTensor(
            packed=torch.cat([t.packed for t in qts], dim=-1),
            scales=torch.cat([t.scales for t in qts], dim=-1),
            g=first.g,
            k=first.k,
            o=sum(t.o for t in qts),
            fmt=first.fmt,
        )


_REGISTRY: Dict[str, QuantFormat] = {}


def register_format(fmt: QuantFormat) -> QuantFormat:
    """Register a format instance under ``fmt.name`` (last write wins)."""
    _REGISTRY[fmt.name] = fmt
    return fmt


def get_format(name: str) -> QuantFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown quantization format {name!r}; registered formats: "
            f"{sorted(_REGISTRY)}"
        ) from None


def format_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


class BCQFormat(QuantFormat):
    """Group-wise binary-coding quantization, the paper's format: q sign
    planes and q per-group scale planes. Kernels: ``bcq_mm`` (unpack in
    registers, the ``auto`` choice) and ``lutgemm`` (the paper's LUT)."""

    name = "bcq"
    impls = ("bcq_mm", "lutgemm")
    supports_truncate = True

    def quantize(
        self, w, *, q, g, scale_dtype=torch.bfloat16, method="alternating", iters=8
    ) -> QuantizedTensor:
        k, o = w.shape
        if method == "alternating":
            scales, binary = bcq_lib.quantize_bcq(w, q=q, g=g, iters=iters)
        elif method == "greedy":
            scales, binary = bcq_lib.quantize_bcq_greedy(w, q=q, g=g)
        else:
            raise ValueError(f"unknown method {method!r}")
        return QuantizedTensor(
            packed=packing.pack_signs(binary),
            scales=scales.to(scale_dtype),
            g=g,
            k=k,
            o=o,
            fmt=self.name,
        )

    def dequantize(self, qt, dtype=torch.float32):
        signs = packing.unpack_signs(qt.packed)  # (…, q, k, o) int8
        w = bcq_lib.dequantize(qt.scales.to(torch.float32), signs, qt.g)
        return w.to(dtype)

    def matvec(self, xb, qt, *, impl, out_dims):
        from repro_torch.kernels.bcq_mm import bcq_mm
        from repro_torch.kernels.bcq_mm_fused import bcq_mm_fused
        from repro_torch.kernels.lutgemm import lutgemm

        if impl == "bcq_mm":
            if len(out_dims) > 1:
                return bcq_mm_fused(xb, qt.packed, qt.scales, g=qt.g, out_dims=out_dims)
            return (bcq_mm(xb, qt.packed, qt.scales, g=qt.g),)
        return split_outputs(lutgemm(xb, qt.packed, qt.scales, g=qt.g), out_dims)

    def truncate(self, qt, q_new):
        """The nested ``q_new``-bit approximation: the greedy solver builds
        plane ``i`` from the residual of planes ``< i``, so ``packed[:q_new],
        scales[:q_new]`` is what the solver would emit at ``q=q_new``."""
        if not 1 <= q_new <= qt.q:
            raise ValueError(f"cannot truncate q={qt.q} tensor to q'={q_new}")
        if q_new == qt.q:
            return qt
        return qt.replace(
            packed=qt.packed[..., :q_new, :, :], scales=qt.scales[..., :q_new, :, :]
        )


register_format(BCQFormat())
