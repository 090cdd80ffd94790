"""QuantFormat — the quantization-format protocol and registry (counterpart of
``repro/core/formats.py``).

A format owns how a weight is packed, which kernels consume the packed form
and which capabilities (nested truncation, output-dim fusion) it supports.
Everything else reaches it through :func:`repro_torch.kernels.ops.qmatmul`.

Registered formats (kernels in ``kernels/``, CUDA sources in ``csrc/``):

============  ========  ==================================================
format        truncate  kernels
============  ========  ==================================================
``bcq``       yes       ``bcq_mm`` (fused leaves: ``bcq_mm_fused``), ``lutgemm``
``uniform``   no        ``uniform_mm``: q code planes, ``s·code + z`` per group
``dequant``   no        ``dequant_mm``: ``dequant_materialize`` + ``torch.matmul``
``codebook``  no        ``codebook_mm``: per-(group, column) table of 2^q centroids
``ternary``   yes       ``ternary_mm``: sign + mask planes, one ``alpha`` per group
============  ========  ==================================================

Shared physical layout: ``packed (…, P, k//8, o)`` uint8 code planes and
``scales (…, S, k//g, o)`` group parameters; P, S and the reconstruction
rule are the format's business. Every format fuses along the output dim.
"""

from __future__ import annotations

import abc
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core import bcq as bcq_lib
from repro_torch.core import packing
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.utils import matmul_rows


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
        self,
        xb: torch.Tensor,
        qt: QuantizedTensor,
        *,
        impl: str,
        out_dims: Sequence[int],
        token_rows: bool = False,
    ) -> Tuple[torch.Tensor, ...]:
        """Kernel entry: ``(B, k) @ qt`` → the ``(B, o_i)`` f32 pieces of
        ``out_dims``, consuming the packed form through the kernel ``impl``.
        ``token_rows``: each row of ``xb`` is one token of its own request
        (:func:`~repro_torch.utils.token_rows`); the packed kernels sum a row
        alike at every B anyway, and ``dequant`` tiles its GEMM by it."""

    def matmul(self, xb: torch.Tensor, qt: QuantizedTensor, *, dtype) -> torch.Tensor:
        """Oracle entry: dequantize into ``dtype`` and run a dense product
        accumulated in f32: ``(B, ..., k)`` → ``(B, ..., o)`` f32, a batch
        row's result independent of B (:func:`~repro_torch.utils.matmul_rows`)."""
        w = self.dequantize(qt, dtype=dtype)
        return matmul_rows(xb.to(dtype).to(torch.float32), w.to(torch.float32))

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

    def planes(self, q: int) -> int:
        """Packed code planes a ``q``-bit quantization stores."""
        return q

    @abc.abstractmethod
    def scales_shape(self, q: int, groups: int, o: int) -> Tuple[int, ...]:
        """Shape of the per-(group, column) parameter planes."""

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

    def matvec(self, xb, qt, *, impl, out_dims, token_rows=False):
        from repro_torch.kernels.bcq_mm import bcq_mm
        from repro_torch.kernels.bcq_mm_fused import bcq_mm_fused
        from repro_torch.kernels.lutgemm import lutgemm

        if impl == "bcq_mm":
            if len(out_dims) > 1:
                return bcq_mm_fused(xb, qt.packed, qt.scales, g=qt.g, out_dims=out_dims)
            return (bcq_mm(xb, qt.packed, qt.scales, g=qt.g),)
        return split_outputs(lutgemm(xb, qt.packed, qt.scales, g=qt.g), out_dims)

    def scales_shape(self, q, groups, o):
        return (q, groups, o)

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


def _grouped(t: torch.Tensor, g: int) -> torch.Tensor:
    """``(…, k, o)`` → ``(…, k/g, g, o)``."""
    *lead, k, o = t.shape
    return t.reshape(*lead, k // g, g, o)


def uniform_dequantize(packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """Uniform planes ``(…, q, k/8, o)`` and ``(…, 2, k/g, o)`` scale/zero →
    ``w = code·s + z`` ``(…, k, o)`` f32 (a product, then a sum: two
    roundings, as the reference and the CUDA kernels round)."""
    codes = _grouped(packing.unpack_codes(packed).to(torch.float32), g)
    s = scales[..., 0, :, :].to(torch.float32)[..., :, None, :]
    z = scales[..., 1, :, :].to(torch.float32)[..., :, None, :]
    w = codes * s + z
    return w.reshape(*w.shape[:-3], -1, w.shape[-1])


def ternary_dequantize(packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """Sign + mask planes ``(…, 2, k/8, o)`` and ``(…, 1, k/g, o)`` alpha →
    ``w = (2·sign − 1)·mask·alpha`` ``(…, k, o)`` f32."""
    planes = packing.unpack_signs(packed).to(torch.float32)  # (…, 2, k, o) ±1
    t = planes[..., 0, :, :] * ((planes[..., 1, :, :] + 1.0) * 0.5)
    alpha = scales[..., 0, :, :].to(torch.float32)[..., :, None, :]
    w = _grouped(t, g) * alpha
    return w.reshape(*w.shape[:-3], -1, w.shape[-1])


def codebook_dequantize(packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """Index planes ``(…, q, k/8, o)`` and the ``(…, 2^q, k/g, o)`` centroid
    table → ``w[r, c] = T[idx[r, c], r // g, c]`` ``(…, k, o)`` f32."""
    idx = _grouped(packing.unpack_codes(packed).to(torch.int64), g)  # (…, G, g, o)
    cent = scales.to(torch.float32).transpose(-3, -2)  # (…, G, 2^q, o)
    w = torch.gather(cent, -2, idx)
    return w.reshape(*w.shape[:-3], -1, w.shape[-1])


class UniformFormat(QuantFormat):
    """Group-wise uniform int-q (FineQuant style): q magnitude bit planes and
    a ``(scale, zero)`` pair per group. Kernel: ``uniform_mm`` (codes
    reassembled and the affine applied in registers, one pass)."""

    name = "uniform"
    impls = ("uniform_mm",)

    def quantize(
        self, w, *, q, g, scale_dtype=torch.bfloat16, method="alternating", iters=8
    ) -> QuantizedTensor:
        """Closed-form per-group affine: ``s = max((max − min)/(2^q − 1),
        1e-8)``, ``code = clip(round((w − min)/s), 0, 2^q − 1)`` with
        ``round`` half to even. ``method``/``iters`` are ignored."""
        del method, iters
        k, o = w.shape
        bcq_lib._check_args(k, q, g)
        grouped = _grouped(w.to(torch.float32), g)
        wmin = grouped.amin(dim=1)  # (G, o)
        wmax = grouped.amax(dim=1)
        scale = torch.clamp_min((wmax - wmin) / (2**q - 1), 1e-8)
        codes = torch.clamp(
            torch.round((grouped - wmin[:, None, :]) / scale[:, None, :]), 0, 2**q - 1
        )
        return QuantizedTensor(
            packed=packing.pack_codes(codes.reshape(k, o).to(torch.uint8), q),
            scales=torch.stack([scale, wmin]).to(scale_dtype),  # (2, G, o)
            g=g,
            k=k,
            o=o,
            fmt=self.name,
        )

    def dequantize(self, qt, dtype=torch.float32):
        return uniform_dequantize(qt.packed, qt.scales, qt.g).to(dtype)

    def matvec(self, xb, qt, *, impl, out_dims, token_rows=False):
        from repro_torch.kernels.uniform_mm import uniform_mm

        return split_outputs(uniform_mm(xb, qt.packed, qt.scales, g=qt.g), out_dims)

    def scales_shape(self, q, groups, o):
        return (2, groups, o)


class DequantFormat(UniformFormat):
    """The paper's baseline: ``uniform``'s representation served the slow way
    round, materialising the dense weight in device memory and then running
    a stock GEMM (the OPTQ / nuQmm recipe of paper Table 3 / Fig. 9)."""

    name = "dequant"
    impls = ("dequant_mm",)

    def matvec(self, xb, qt, *, impl, out_dims, token_rows=False):
        from repro_torch.kernels.dequant_mm import dequant_mm

        return split_outputs(dequant_mm(xb, qt.packed, qt.scales, g=qt.g, token_rows=token_rows), out_dims)


# The QLoRA NF4 grid: 16 quantiles of N(0, 1) normalised to [-1, 1]; a weight
# group is coded as ``absmax · level`` (the fixed-codebook special case).
_NF4_LEVELS = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

# Elements of one ``(G, g, 2^q, o_chunk)`` distance block of the k-means
# (f32: 128 MiB). Columns are independent, so ``CodebookFormat.quantize``
# solves column chunks one after another; the chunking changes at most the
# order in which a cluster's sum is added up.
_KMEANS_BLOCK_ELEMS = 1 << 25


def _quantile_linear(grouped: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(grouped, probs, axis=1)`` with the ``linear`` method,
    from a sort (``torch.quantile`` refuses more than 2^24 elements):
    ``(G, g, o)`` → ``(G, len(probs), o)``."""
    srt = torch.sort(grouped, dim=1).values
    n = grouped.shape[1]
    pos = probs * (n - 1)
    low = torch.floor(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo = torch.clamp(low, 0, n - 1).long()
    hi = torch.clamp(torch.ceil(pos), 0, n - 1).long()
    return srt[:, lo, :] * lw[None, :, None] + srt[:, hi, :] * hw[None, :, None]


def _kmeans_centroids(grouped: torch.Tensor, q: int, iters: int) -> torch.Tensor:
    """Per-(group, column) 1-D Lloyd k-means: ``(G, g, o)`` → ``(G, 2^q, o)``.

    Quantile init (centroid ``i`` at the ``(i+0.5)/2^q`` quantile of the
    group, ``linear`` method), then ``max(iters, 1)`` assign/update rounds;
    an empty cluster keeps its old centroid."""
    n = 1 << q
    probs = (torch.arange(n, dtype=torch.float32, device=grouped.device) + 0.5) / n
    cent = _quantile_linear(grouped, probs)
    ids = torch.arange(n, device=grouped.device)[None, None, :, None]
    for _ in range(max(int(iters), 1)):
        d = torch.abs(grouped[:, :, None, :] - cent[:, None, :, :])  # (G, g, n, o)
        onehot = (torch.argmin(d, dim=2)[:, :, None, :] == ids).to(torch.float32)
        del d
        counts = onehot.sum(dim=1)  # (G, n, o)
        sums = (grouped[:, :, None, :] * onehot).sum(dim=1)
        cent = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), cent)
    return cent


class CodebookFormat(QuantFormat):
    """Arbitrary scalar codebook per (group, column) (FLUTE style): ``2^q``
    centroids in the scales planes, ``q`` index bit planes in the packed
    planes. Kernel: ``codebook_mm`` (each block stages its slice of the
    table in shared memory and looks centroids up by index)."""

    name = "codebook"
    impls = ("codebook_mm",)

    def quantize(
        self, w, *, q, g, scale_dtype=torch.bfloat16, method="alternating", iters=8
    ) -> QuantizedTensor:
        """``method``: ``alternating`` / ``greedy`` / ``kmeans`` run per-group
        Lloyd k-means; ``nf4`` takes the fixed QLoRA grid scaled by the group
        absmax (needs ``q == 4``). Column chunks are solved one after another
        to bound the ``(G, g, 2^q, o)`` distance block."""
        k, o = w.shape
        bcq_lib._check_args(k, q, g)
        if method == "nf4" and q != 4:
            raise ValueError(f"method 'nf4' is a fixed 16-entry codebook; needs q=4, got q={q}")
        if method not in ("nf4", "alternating", "greedy", "kmeans"):
            raise ValueError(f"unknown method {method!r}")
        n = 1 << q
        grouped_all = _grouped(w.to(torch.float32), g)
        chunk = max(1, min(o, _KMEANS_BLOCK_ELEMS // (k * n)))
        codes_c, cent_c = [], []
        for c0 in range(0, o, chunk):
            grouped = grouped_all[:, :, c0 : c0 + chunk]
            if method == "nf4":
                levels = torch.tensor(_NF4_LEVELS, dtype=torch.float32, device=w.device)
                absmax = grouped.abs().amax(dim=1)  # (G, oc)
                cent = levels[None, :, None] * absmax[:, None, :]
            else:
                cent = _kmeans_centroids(grouped, q, iters)
            codes_c.append(torch.argmin(
                torch.abs(grouped[:, :, None, :] - cent[:, None, :, :]), dim=2
            ).to(torch.uint8))  # (G, g, oc)
            cent_c.append(cent)
        codes = torch.cat(codes_c, dim=-1).reshape(k, o)
        cent = torch.cat(cent_c, dim=-1)
        return QuantizedTensor(
            packed=packing.pack_codes(codes, q),
            scales=cent.transpose(0, 1).contiguous().to(scale_dtype),  # (2^q, G, o)
            g=g,
            k=k,
            o=o,
            fmt=self.name,
        )

    def dequantize(self, qt, dtype=torch.float32):
        return codebook_dequantize(qt.packed, qt.scales, qt.g).to(dtype)

    def matvec(self, xb, qt, *, impl, out_dims, token_rows=False):
        from repro_torch.kernels.codebook_mm import codebook_mm

        return split_outputs(codebook_mm(xb, qt.packed, qt.scales, g=qt.g), out_dims)

    def scales_shape(self, q, groups, o):
        return (1 << q, groups, o)


class TernaryFormat(QuantFormat):
    """{-1, 0, +1} codes (T-MAC ``tl2`` style) as two packed bit planes (sign,
    nonzero mask) and one per-group magnitude ``alpha``. Kernel:
    ``ternary_mm``.

    Ternary is masked BCQ: ``t = 0.5·b1 + 0.5·b2`` with ``b1 = sign | ~mask``
    and ``b2 = sign & mask`` on the packed bytes, exact in float, which is
    what makes ``truncate`` available (a nested 1-plane BCQ draft).
    """

    name = "ternary"
    impls = ("ternary_mm",)
    supports_truncate = True

    PLANES = 2  # sign + mask, fixed: the policy's q does not change storage

    def quantize(
        self, w, *, q, g, scale_dtype=torch.bfloat16, method="alternating", iters=8
    ) -> QuantizedTensor:
        """TWN ternarisation per (group, column): threshold ``Δ = 0.75·mean|w|``,
        then ``max(iters, 1)`` refinements of ``alpha = mean(|w| over mask)``
        and ``Δ = alpha/2``. ``q``/``method`` do not change the stored planes."""
        del q, method
        k, o = w.shape
        bcq_lib._check_args(k, self.PLANES, g)
        grouped = _grouped(w.to(torch.float32), g)
        absg = grouped.abs()
        delta = 0.75 * absg.mean(dim=1)  # (G, o)
        for _ in range(max(int(iters), 1)):
            mask = absg > delta[:, None, :]
            cnt = torch.clamp_min(mask.sum(dim=1), 1)
            alpha = (absg * mask).sum(dim=1) / cnt
            delta = 0.5 * alpha
        mask = absg > delta[:, None, :]
        sign_pm = torch.where(grouped >= 0, 1, -1).to(torch.int8)
        mask_pm = torch.where(mask, 1, -1).to(torch.int8)
        planes = torch.stack([sign_pm, mask_pm]).reshape(self.PLANES, k, o)
        return QuantizedTensor(
            packed=packing.pack_signs(planes),
            scales=alpha[None].to(scale_dtype),  # (1, G, o)
            g=g,
            k=k,
            o=o,
            fmt=self.name,
        )

    def dequantize(self, qt, dtype=torch.float32):
        return ternary_dequantize(qt.packed, qt.scales, qt.g).to(dtype)

    def matvec(self, xb, qt, *, impl, out_dims, token_rows=False):
        from repro_torch.kernels.ternary_mm import ternary_mm

        return split_outputs(ternary_mm(xb, qt.packed, qt.scales, g=qt.g), out_dims)

    def planes(self, q):
        return self.PLANES

    def scales_shape(self, q, groups, o):
        return (1, groups, o)

    def as_bcq(self, qt: QuantizedTensor) -> QuantizedTensor:
        """The exact 2-plane BCQ view: ``b1 = sign | ~mask``, ``b2 = sign &
        mask`` on the packed bytes, each plane scaled ``alpha/2``, so
        ``dequantize(as_bcq(qt)) == dequantize(qt)`` bit for bit."""
        b1, half = self._b1_plane(qt)
        b2 = qt.packed[..., 0, :, :] & qt.packed[..., 1, :, :]  # sign & mask
        return qt.replace(
            packed=torch.stack([b1, b2], dim=-3),
            scales=torch.cat([half, half], dim=-3),  # (…, 2, G, o)
            fmt="bcq",
        )

    @staticmethod
    def _b1_plane(qt):
        """The first BCQ plane of a ternary tensor, ``b1 = sign | ~mask``,
        and its scales ``alpha/2`` (shared by both planes) → (packed, half)."""
        sign = qt.packed[..., 0, :, :]
        mask = qt.packed[..., 1, :, :]
        return sign | ~mask, (0.5 * qt.scales.to(torch.float32)).to(qt.scales.dtype)

    def truncate(self, qt, q_new):
        """``q_new == 2`` is the tensor itself (served by ``ternary_mm``);
        ``q_new == 1`` is the ``b1 = sign | ~mask`` plane of :meth:`as_bcq`
        as a 1-plane BCQ tensor, whose drafts run through ``bcq_mm``. Only
        that plane is built (a contiguous tensor), not both."""
        if not 1 <= q_new <= self.PLANES:
            raise ValueError(
                f"cannot truncate ternary tensor to q'={q_new} (valid: 1..{self.PLANES})"
            )
        if q_new == self.PLANES:
            return qt
        b1, half = self._b1_plane(qt)
        return qt.replace(packed=b1.unsqueeze(-3), scales=half, fmt="bcq")


register_format(BCQFormat())
register_format(UniformFormat())
register_format(DequantFormat())
register_format(CodebookFormat())
register_format(TernaryFormat())
