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

``expert_matmul(fmt, buf, qt)`` is the same dispatch for an MoE bank:
``buf (E, C, k)`` against E experts' packed weights ``(E, k, o)`` → ``(E,
C, o)`` f32 (:func:`expert_linear` also takes a dense bank;
:func:`expert_linear_pair` two banks over one buffer, gate and up).
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


# format → the group-table kind its kernel takes for a bank (K12); ternary only
# off its tensor cores (f32 x or f32 alpha)
_GROUPED_KINDS = {("bcq", "bcq_mm"): "bcq", ("uniform", "uniform_mm"): "uniform",
                  ("ternary", "ternary_mm"): "ternary"}


def _grouped_kind(f, impl: str, buf: torch.Tensor, qt: QuantizedTensor) -> Optional[str]:
    """The group-table kind K12 takes for this bank, or None (another kernel,
    expert by expert: ternary bf16 with bf16 alpha runs on K4's tensor cores)."""
    kind = _GROUPED_KINDS.get((f.name, impl))
    if kind == "ternary" and buf.dtype == torch.bfloat16 and qt.scales.dtype == torch.bfloat16:
        return None
    return kind


def _resolve_bank(fmt, buf: torch.Tensor, qt: QuantizedTensor, impl: str):
    f = get_format(fmt) if isinstance(fmt, str) else fmt
    E, C, k = buf.shape
    if qt.packed.dim() != 4 or qt.packed.shape[0] != E:
        raise ValueError(f"expert bank packed {tuple(qt.packed.shape)} does not lead with the {E} experts of buf")
    if k != qt.k:
        raise ValueError(f"buf reduction dim {k} != weight k {qt.k}")
    if impl == "auto" and _IMPL_MODE is not None:
        impl = _IMPL_MODE
    return f, f.resolve_impl(impl, buf)


def expert_matmul(fmt, buf: torch.Tensor, qt: QuantizedTensor, *, impl: str = "auto",
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``buf (E, C, k)`` against a bank of E experts' packed weights (``qt``
    with a leading ``(E,)``, each ``(k, o)``) → ``(E, C, o)`` f32.

    Dispatch, as :func:`qmatmul`'s:

    - ``impl="ref"`` (or ``impl_mode("ref")``): the reference's ``_w``
      route, the format's dequantize of the whole bank to ``buf``'s dtype,
      then one batched product accumulated in f32: the oracle.
    - a kernel, for ``bcq`` on ``bcq_mm``, ``uniform``, and ``ternary`` with
      f32 x or f32 alpha (the group-table kinds): K12
      (:func:`~repro_torch.kernels.expert_mm.expert_mm`), one launch for
      the bank; ``rows`` ((E,) int32 on the device, an expert's filled
      buffer rows) lets it skip the rest, which it leaves zero.
    - any other kernel: that format's kernel on each expert's view in turn:
      ``codebook`` (K7), ``dequant`` (K6 and its GEMM), ``ternary`` bf16
      with bf16 alpha (K4 on its tensor cores) and ``impl_mode("lutgemm")``
      (K3). Those kernels take one matrix; looping over the experts is how
      their formats serve a bank, by design.

    The oracle and the expert-by-expert kernels compute every row; a row
    past ``rows[e]`` of a dispatch buffer holds zeros, so it comes out zero
    on every path. On a CPU tensor the kernels' plain versions run, as
    everywhere."""
    f, impl = _resolve_bank(fmt, buf, qt, impl)
    if impl == "ref":
        qmatmul.ref_calls += 1
        w = f.dequantize(qt, dtype=buf.dtype)  # (E, k, o)
        return torch.bmm(buf.to(torch.float32), w.to(torch.float32))
    kind = _grouped_kind(f, impl, buf, qt)
    if kind is not None:
        from repro_torch.kernels.expert_mm import expert_mm

        return expert_mm(buf, qt.packed, qt.scales, g=qt.g, kind=kind, rows=rows)
    return torch.stack([
        f.matvec(buf[e], qt.replace(packed=qt.packed[e], scales=qt.scales[e]), impl=impl, out_dims=(qt.o,))[0]
        for e in range(buf.shape[0])
    ])


def expert_linear(buf: torch.Tensor, w, *, impl: str = "auto", rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An MoE bank's product ``buf (E, C, k) @ w (E, k, o)`` → ``(E, C, o)``
    f32: :func:`expert_matmul` for a packed bank; a dense bank is one
    batched product of ``buf`` against ``w`` in ``buf``'s dtype, accumulated
    in f32 (the reference's einsum with ``preferred_element_type=f32``)."""
    if isinstance(w, QuantizedTensor):
        return expert_matmul(w.fmt, buf, w, impl=impl, rows=rows)
    return torch.bmm(buf.to(torch.float32), w.to(buf.dtype).to(torch.float32))


def expert_linear_pair(buf: torch.Tensor, w_a, w_b, *, impl: str = "auto",
                       rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two banks over one buffer (an MoE layer's gate and up) → two ``(E, C,
    o)`` f32 outputs: one K12 launch
    (:func:`~repro_torch.kernels.expert_mm.expert_mm_pair`) when both are
    packed banks of one format, shape and scale dtype that take K12, else
    :func:`expert_linear` on each; the same bits either way."""
    if isinstance(w_a, QuantizedTensor) and isinstance(w_b, QuantizedTensor) and w_a.fmt == w_b.fmt:
        f, resolved = _resolve_bank(w_a.fmt, buf, w_a, impl)
        kind = _grouped_kind(f, resolved, buf, w_a)
        same = (w_a.packed.shape == w_b.packed.shape and w_a.scales.shape == w_b.scales.shape
                and w_a.scales.dtype == w_b.scales.dtype and w_a.g == w_b.g)
        if kind is not None and same:
            from repro_torch.kernels.expert_mm import expert_mm_pair

            return expert_mm_pair(buf, (w_a.packed, w_a.scales), (w_b.packed, w_b.scales), g=w_a.g, kind=kind,
                                  rows=rows)
    return expert_linear(buf, w_a, impl=impl, rows=rows), expert_linear(buf, w_b, impl=impl, rows=rows)


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
