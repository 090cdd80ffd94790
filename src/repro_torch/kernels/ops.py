"""The one quantized-matmul dispatch the rest of the port calls (counterpart
of ``repro/kernels/ops.py``).

``qmatmul(fmt, x, qt, ...)`` is the entry point for ``x @ W`` against a
packed :class:`~repro_torch.core.qtensor.QuantizedTensor`: it resolves the
registered format and routes to that format's kernels.

- ``impl="ref"``   the format's dequantize + dense-product oracle.
- ``impl="auto"``  the format's preferred kernel for a CUDA tensor (``bcq``:
                   ``bcq_mm``, or ``bcq_mm_fused`` for a fused leaf;
                   ``uniform_mm``, ``dequant_mm``, ``ternary_mm``,
                   ``codebook_mm`` for the other formats), ``ref`` for a CPU
                   tensor; :func:`impl_mode` may override it.
- explicit impls   any of the format's kernels (``bcq``: ``bcq_mm``,
                   ``lutgemm``). On a CPU tensor a kernel wrapper runs its
                   plain PyTorch version.

Passing ``out_dims`` runs the fused multi-projection path: N projections of
one activation whose packed weights were concatenated along the output dim
run as one kernel launch over the concatenated o, split into N outputs.

Leading batch dims are flattened into the kernel's row dim and restored; a
call whose rows are one token each (``(B, 1, k)``, a decode step) says so to
the format (``token_rows``), so a product that sums by the row count (the
``dequant`` GEMM) can keep each row's bits independent of B.
Every path returns values computed in f32, cast to ``out_dtype`` (default:
``x``'s dtype).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.formats import get_format, split_outputs
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.utils import matmul_rows, token_rows

# How ``impl="auto"`` resolves, overridable per scope via :func:`impl_mode`:
#   None       the format's own policy (kernel on the GPU, ref on the CPU);
#   "ref"      the dequantize + product oracle everywhere (numerics A/B),
#              and the plain causal attention (``models/layers._causal``);
#   a kernel   that kernel of the format everywhere (e.g. "lutgemm", to serve
#              a model through the paper's LUT kernel).
_IMPL_MODE: Optional[str] = None


@contextlib.contextmanager
def impl_mode(mode: Optional[str]):
    """Scope an ``impl="auto"`` resolution override. Explicit impls win.
    Not thread-safe (one module-level setting)."""
    global _IMPL_MODE
    if mode is not None and not isinstance(mode, str):
        raise ValueError(f"impl_mode {mode!r}: expected None, 'ref' or a kernel name")
    prev = _IMPL_MODE
    _IMPL_MODE = mode
    try:
        yield
    finally:
        _IMPL_MODE = prev


def current_impl_mode() -> Optional[str]:
    """The :func:`impl_mode` in force (None outside any scope)."""
    return _IMPL_MODE


def qmatmul(
    fmt,
    x: torch.Tensor,
    qt: QuantizedTensor,
    out_dims: Optional[Sequence[int]] = None,
    *,
    impl: str = "auto",
    out_dtype=None,
) -> Tuple[torch.Tensor, ...]:
    """``x (..., k) @ qt (k, o)`` through the registered format's kernels.

    ``out_dims=None`` is the single-projection case, returned as a 1-tuple;
    otherwise ``qt`` holds N output-fused projections and one kernel launch
    returns N ``(..., o_i)`` slices.
    """
    f = get_format(fmt) if isinstance(fmt, str) else fmt
    out_dims = (qt.o,) if out_dims is None else tuple(out_dims)
    if sum(out_dims) != qt.o:
        raise ValueError(f"out_dims {out_dims} do not sum to fused o={qt.o}")
    if impl == "auto" and _IMPL_MODE is not None:
        impl = _IMPL_MODE
    impl = f.resolve_impl(impl, x)
    out_dtype = out_dtype or x.dtype

    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != qt.k:
        raise ValueError(f"x reduction dim {k} != weight k {qt.k}")
    xb = x.reshape(-1, k)

    if impl == "ref":
        qmatmul.ref_calls += 1
        xr = x.reshape(x.shape[0], -1, k) if x.dim() > 2 else xb  # batch rows kept apart
        parts = split_outputs(f.matmul(xr, qt, dtype=x.dtype), out_dims)
    else:
        parts = f.matvec(xb, qt, impl=impl, out_dims=out_dims, token_rows=token_rows(x))
    return tuple(
        part.reshape(*lead, d).to(out_dtype) for part, d in zip(parts, out_dims)
    )


qmatmul.ref_calls = 0  # dispatches that took the oracle instead of a kernel


def quantized_matmul(
    x: torch.Tensor, qt: QuantizedTensor, *, impl: str = "auto", out_dtype=None
) -> torch.Tensor:
    """``x (..., k) @ qt (k, o)`` → ``(..., o)`` (single-projection shim)."""
    (y,) = qmatmul(qt.fmt, x, qt, impl=impl, out_dtype=out_dtype)
    return y


def quantized_matmul_fused(
    x: torch.Tensor,
    qt: QuantizedTensor,
    out_dims: Sequence[int],
    *,
    impl: str = "auto",
    out_dtype=None,
) -> Tuple[torch.Tensor, ...]:
    """``x (..., k)`` against N fused projections → N ``(..., o_i)`` outputs."""
    return qmatmul(qt.fmt, x, qt, out_dims, impl=impl, out_dtype=out_dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    """Dense ``x @ w`` with f32 accumulation: in f32 when either side or the
    output is f32, else in ``x``'s dtype (f32-accumulated by the library);
    a batch row's result independent of B (:func:`~repro_torch.utils.matmul_rows`:
    one batch row at a time on the CPU, decode rows in fixed tiles on the GPU)."""
    if out_dtype == torch.float32 or x.dtype == torch.float32:
        return matmul_rows(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    return matmul_rows(x, w.to(x.dtype))


def linear(
    x: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    *,
    impl: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """Linear layer: ``w`` is a dense (k, o) tensor or a QuantizedTensor."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedTensor):
        (y,) = qmatmul(w.fmt, x, w, impl=impl, out_dtype=out_dtype)
    else:
        y = _dense(x, w, out_dtype).to(out_dtype)
    if b is not None:
        y = y + b.to(out_dtype)
    return y


def linear_fused(
    x: torch.Tensor,
    w,
    out_dims: Sequence[int],
    *,
    impl: str = "auto",
    out_dtype=None,
) -> Tuple[torch.Tensor, ...]:
    """N projections of one activation from output-fused weights (one kernel
    launch for a QuantizedTensor, one product for a dense tensor)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedTensor):
        return qmatmul(w.fmt, x, w, out_dims, impl=impl, out_dtype=out_dtype)
    return split_outputs(_dense(x, w, out_dtype).to(out_dtype), tuple(out_dims))
