"""K12: a bank of experts' packed products in one launch,
``out[e] = x[e] @ W_e`` for every expert e of an MoE bank.

Replaces no ``pallas_call``: the reference's expert path
(``src/repro/models/moe.py``, ``_w`` and the grouped einsums of
``_moe_apply_global``) dequantizes each packed bank to the compute dtype in
plain jnp and leaves the einsums to XLA. On the card that round trip would
write and read a dense bf16 copy of every bank each step (805 MB a layer of
olmoe-1b-7b), so the port gives the computation a kernel of its own, as it
does the reference's ``lax.scan`` recurrences (K9-K11).

The CUDA kernel is the group-table skeleton of K1 / K5 / K4's CUDA-core
path (``csrc/grouptable.cuh``, ``expert_grouptable_kernel``) on a bank plan
of its own (``grouptable.bank_plan``): a block owns a column tile, a row
tile of 8 and one expert of one bank, and walks all of k, in the k-chunks
of the plan ``grouptable.plan`` makes for one expert. Where those chunks
are 8 byte rows (olmoe-1b-7b's banks) it walks by columns: 4 warps, one
column a thread, each row's 8 products from 0, a chunk's rows in order,
the chunks in order. Otherwise it walks by chunks: 8 warps share the
columns as in K1 and a chunk's warp sums meet in shared memory. Either
way a row's sum is added in the order in which K1's last block adds it
from its split scratch, so each expert's rows get exactly the bits the
format's kernel gives when called on that expert alone, with no scratch
and one launch a bank at any capacity. ``rows`` (the dispatch's
per-expert counts, on the device) lets the blocks of an expert's empty
row tiles exit before they read its weights; rows at or past ``rows[e]``
are zero. :func:`expert_mm_pair` runs two banks of one plan over the same
x in one launch (an MoE layer's gate and up).

Formats: ``bcq`` (K1's table), ``uniform`` (K5's) and ``ternary`` (K4's
group-table path: f32 x or f32 alpha; bf16 with bf16 alpha takes K4's
tensor cores expert by expert, ``kernels/ops.py::expert_matmul``).

:func:`expert_mm` and :func:`expert_mm_pair` launch the kernel for CUDA
tensors (or raise) and run :func:`expert_mm_plain` for CPU tensors.
``expert_mm.launches`` counts kernel launches: one a call of either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import grouptable
from repro_torch.kernels._common import forward_only, validate
from repro_torch.kernels.bcq_mm import bcq_mm_plain
from repro_torch.kernels.ternary_mm import PLANES as TERNARY_PLANES
from repro_torch.kernels.ternary_mm import ternary_mm_plain
from repro_torch.kernels.uniform_mm import uniform_mm_plain

KINDS = ("bcq", "uniform", "ternary")
_PLAIN = {"bcq": bcq_mm_plain, "uniform": uniform_mm_plain, "ternary": ternary_mm_plain}


def _validate(kind: str, x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"expert_mm: kind {kind!r}; the group-table kinds are {KINDS}")
    if x.dim() != 3 or packed.dim() != 4 or scales.dim() != 4:
        raise ValueError(
            f"expected x (E, C, k), packed (E, P, k/8, o) and scales (E, S, k/g, o); got "
            f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scales.shape)}"
        )
    if not x.shape[0] == packed.shape[0] == scales.shape[0]:
        raise ValueError(f"expert counts differ: x {x.shape[0]}, packed {packed.shape[0]}, scales {scales.shape[0]}")
    if kind == "ternary" and packed.shape[1] != TERNARY_PLANES:
        raise ValueError(f"ternary packed tensor must carry exactly {TERNARY_PLANES} planes, got {packed.shape[1]}")
    # one expert's view carries every check the single-expert kernels make
    validate(x[0], packed[0], scales[0], g, scale_planes=grouptable.SCALE_PLANES[kind])


def _check_rows(rows: Optional[torch.Tensor], x: torch.Tensor) -> None:
    if rows is None:
        return
    if rows.shape != (x.shape[0],) or rows.dtype != torch.int32 or rows.device != x.device:
        raise ValueError(f"rows must be ({x.shape[0]},) int32 on {x.device}, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")


def expert_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int,
                    kind: str = "bcq", rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: the format's plain kernel on each expert,
    expert e's rows at or past ``rows[e]`` zeroed."""
    plain = _PLAIN[kind]
    out = torch.stack([plain(x[e], packed[e], scales[e], g=g) for e in range(x.shape[0])])
    if rows is None:
        return out
    live = torch.arange(x.shape[1], device=x.device)[None, :] < rows.to(x.device)[:, None]  # (E, C)
    return torch.where(live[..., None], out, torch.zeros_like(out))


def expert_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int,
              kind: str = "bcq", rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, k) @ E experts' [(E, P, k/8, o) planes, (E, S, k/g, o) scales]
    of format ``kind`` → (E, C, o) f32; with ``rows`` ((E,) int32 on x's
    device), expert e's rows at or past ``rows[e]`` are zero.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`expert_mm_plain`.
    """
    _validate(kind, x, packed, scales, g)
    _check_rows(rows, x)
    if not x.is_cuda:
        return expert_mm_plain(x, packed, scales, g=g, kind=kind, rows=rows)
    forward_only("expert_mm", x, scales)
    (out,), n = grouptable.launch_grouped(kind, x, [(packed, scales)], g, rows)
    expert_mm.launches += n
    return out


def expert_mm_pair(x: torch.Tensor, bank_a: Tuple[torch.Tensor, torch.Tensor],
                   bank_b: Tuple[torch.Tensor, torch.Tensor], *, g: int, kind: str = "bcq",
                   rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`expert_mm` of one x against two banks ``(packed, scales)`` of
    the same shapes and dtypes (an MoE layer's gate and up) → two (E, C, o)
    f32 outputs, in one launch on the card (each bit for bit its own
    :func:`expert_mm`)."""
    for packed, scales in (bank_a, bank_b):
        _validate(kind, x, packed, scales, g)
    (pa, sa), (pb, sb) = bank_a, bank_b
    if pa.shape != pb.shape or sa.shape != sb.shape or sa.dtype != sb.dtype:
        raise ValueError(f"expert_mm_pair: the banks differ: packed {tuple(pa.shape)} / {tuple(pb.shape)}, scales "
                         f"{tuple(sa.shape)} {sa.dtype} / {tuple(sb.shape)} {sb.dtype}")
    _check_rows(rows, x)
    if not x.is_cuda:
        return tuple(expert_mm_plain(x, p, s, g=g, kind=kind, rows=rows) for p, s in (bank_a, bank_b))
    forward_only("expert_mm_pair", x, bank_a[1], bank_b[1])
    outs, n = grouptable.launch_grouped(kind, x, [bank_a, bank_b], g, rows)
    expert_mm.launches += n
    return outs


expert_mm.launches = 0
