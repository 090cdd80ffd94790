"""The sLSTM scan (K11): the xLSTM scalar-memory cell over a sequence, for
every (batch row, head), with its hidden-to-hidden products and its state
``h``, ``c``, ``n``, ``m``.

It replaces no ``pallas_call``: it is the port's counterpart of the
reference's ``lax.scan`` over the sLSTM step
(``src/repro/models/recurrent.py:383-403``), which serves every prefill,
decode step and speculative verify of an xLSTM model, and which as eager
PyTorch on the card would be S steps of ~20 launches a layer. The CUDA
kernel is ``csrc/slstm_scan.cu``: a thread-block cluster per (head, tile of
rows), each CTA holding its columns' slice of the four ``R_g`` in shared
memory for the whole launch (:func:`plan`), one thread per (gate, row,
output column), ``h_{t-1}`` exchanged through the cluster's distributed
shared memory once a step; each ``Σ_d h[d] R_g[d, e]`` summed in d order
with products and sums rounded separately, so a row's bits depend on its
own values alone and a scan of S steps equals S decode steps (S = 1).

:func:`slstm_scan` launches the kernel for CUDA tensors (or raises: there
is no fallback) and runs :func:`slstm_scan_plain` for CPU tensors; the
``impl_mode("ref")`` path calls the plain version itself
(``models/recurrent.py``). ``slstm_scan.launches`` counts kernel launches.

``steps`` (ascending step indices) asks for the state after each of those
steps, ``{"h", "c", "n", "m"}`` each ``(n, B, NH, Dh)``, and leaves the state
as it was; without ``steps`` the state after the last step is written in
place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, forward_only
from repro_torch.kernels.mlstm_scan import check_steps
from repro_torch.utils import row_sum

MAX_DH = 256  # csrc/slstm_scan.cu::MAX_DH
MAX_THREADS = 1024  # 4 RB CW threads a CTA
MAX_CLUSTER = 8  # CTAs a cluster: the portable limit
MAX_SMEM = 232448  # dynamic shared memory a CTA may opt in to (227 KB)
GATES = ("z", "i", "f", "o")
STATE = ("h", "c", "n", "m")


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch shape for one head width and R dtype: ``cl`` CTAs
    a cluster, each owning ``Dh / cl`` output columns of the four gates and
    their slice of R; at most ``rb`` rows a cluster; ``smem`` bytes a CTA at
    ``rb`` rows (:func:`smem_bytes`). It sets no sum's order, which depends
    on Dh alone."""

    Dh: int
    cl: int
    rb: int
    smem: int

    @property
    def cols(self) -> int:
        return self.Dh // self.cl


def smem_bytes(Dh: int, cl: int, rb: int, r_bytes: int) -> int:
    """A CTA's shared memory (``csrc/slstm_scan.cu::smem_bytes``): its R
    slice transposed, [4][Dh / cl][DP] (DP: Dh rounded up to 16 bytes, plus
    16 where that leaves an even count of 16-byte pieces), h [2][rb][HS] f32
    (HS: Dh rounded up to 4, plus 4 at a multiple of 32) and the gate values
    [4][rb][Dh / cl] f32."""
    v = 16 // r_bytes
    dp = -(-Dh // v) * v
    dp += 0 if (dp // v) % 2 else v
    hs = -(-Dh // 4) * 4
    hs += 0 if hs % 32 else 4
    return 4 * (Dh // cl) * dp * r_bytes + 2 * rb * hs * 4 + 4 * rb * (Dh // cl) * 4


@functools.lru_cache(maxsize=None)
def plan(Dh: int, r_dtype: torch.dtype) -> Plan:
    """The cluster: the largest ``cl <= MAX_CLUSTER`` dividing Dh that
    leaves a CTA at least ``min(8, Dh)`` columns, so R's slices spread over
    the most SMs; then the most rows a cluster (up to 8) within
    ``MAX_THREADS`` threads and ``MAX_SMEM`` bytes. Raises if even one row
    does not fit (a slice of R too large for one CTA)."""
    if not 1 <= Dh <= MAX_DH:
        raise ValueError(f"slstm_scan: Dh {Dh} must be in 1..{MAX_DH}")
    cl = max(d for d in range(1, MAX_CLUSTER + 1) if Dh % d == 0 and Dh // d >= min(8, Dh))
    rb_bytes = torch.finfo(r_dtype).bits // 8
    rb = min(8, MAX_THREADS // (4 * (Dh // cl)))
    while rb > 0 and smem_bytes(Dh, cl, rb, rb_bytes) > MAX_SMEM:
        rb -= 1
    if rb == 0:
        raise ValueError(f"slstm_scan: Dh {Dh} in {r_dtype}: a slice of R over {cl} CTAs "
                         f"({smem_bytes(Dh, cl, 1, rb_bytes)} bytes) does not fit one CTA's shared memory")
    return Plan(Dh=Dh, cl=cl, rb=rb, smem=smem_bytes(Dh, cl, rb, rb_bytes))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``: on the CPU ``torch.sigmoid`` gives an element
    other bits when it falls in a vector loop's scalar tail, so a row's
    result would depend on the batch; ``exp`` and the division do not."""
    return 1.0 / (1.0 + torch.exp(-x))


def slstm_scan_plain(pre, r, state, steps: Optional[Sequence[int]] = None):
    """The plain PyTorch version: the reference's step for t in order (see
    :func:`slstm_scan`), each ``h R_g`` summed with
    :func:`~repro_torch.utils.row_sum`, whose result for one row does not
    depend on the batch. Same arguments and results as :func:`slstm_scan`."""
    S = pre[0].shape[1]
    keep = set(check_steps(steps, S))
    rf = [w.to(torch.float32) for w in r]
    # from copies: the state's own tensors take the last step's values in place
    # below, and a backward reads the first step's inputs (under a
    # non-reentrant checkpoint's recompute, without autograd's version check)
    h, c, n, m = (t.clone() for t in state)
    hs, kept = [], []
    for t in range(S):
        rec = [row_sum((h[..., :, None] * w).transpose(-1, -2))[..., 0] for w in rf]  # Σ_d h[d] R[d, e]
        z = torch.tanh(pre[0][:, t] + rec[0])
        i_log = pre[1][:, t] + rec[1]
        f_log = F.logsigmoid(pre[2][:, t] + rec[2])
        o = sigmoid(pre[3][:, t] + rec[3])
        fm = f_log + m
        m_new = torch.maximum(fm, i_log)
        ig = torch.exp(i_log - m_new)
        fg = torch.exp(fm - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
        if t in keep:
            kept.append((h, c, n, m))
    out = torch.stack(hs, dim=1) if hs else pre[0].new_zeros(pre[0].shape)
    if steps is None:
        for dst, src in zip(state, (h, c, n, m)):
            dst.copy_(src)
        return out, None
    if not kept:
        return out, {name: s.new_zeros((0, *s.shape)) for name, s in zip(STATE, state)}
    return out, {name: torch.stack([st[i] for st in kept]) for i, name in enumerate(STATE)}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("slstm_scan")
    fn = lib.slstm_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] + [p] * 9 + [p, i] + [p] * 4 + [i] * 6 + [p]
    fn.restype = i
    return lib, fn


def _check(pre, r, state) -> None:
    if len(pre) != 4 or len(r) != 4 or len(state) != 4:
        raise ValueError("slstm_scan: pre and r hold four tensors (z, i, f, o), state four (h, c, n, m)")
    if pre[0].dim() != 4:
        raise ValueError(f"slstm_scan: pre must be (B, S, NH, Dh), got {tuple(pre[0].shape)}")
    B, S, NH, Dh = pre[0].shape
    dev = pre[0].device
    for name, t, want in [*((f"pre_{g}", t, (B, S, NH, Dh)) for g, t in zip(GATES, pre)),
                          *((f"{s}", t, (B, NH, Dh)) for s, t in zip(STATE, state))]:
        if tuple(t.shape) != want:
            raise ValueError(f"slstm_scan: {name} {tuple(t.shape)} must be {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan: {name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"slstm_scan: {name} is on {t.device}, pre_z on {dev}")
    for g, w in zip(GATES, r):
        if tuple(w.shape) != (NH, Dh, Dh):
            raise ValueError(f"slstm_scan: r_{g} {tuple(w.shape)} must be {(NH, Dh, Dh)}")
        if w.dtype not in DTYPE_CODES or w.dtype != r[0].dtype:
            raise TypeError(f"slstm_scan: r_{g} must be float32 or bfloat16, all four alike, got {w.dtype}")
        if w.device != dev:
            raise ValueError(f"slstm_scan: r_{g} is on {w.device}, pre_z on {dev}")
    if Dh > MAX_DH:
        raise ValueError(f"slstm_scan: Dh {Dh} exceeds the kernel's {MAX_DH}")
    if pre[0].is_cuda and Dh > 0:
        plan(Dh, r[0].dtype)  # raises where the slice of R fits no CTA


def slstm_scan(pre, r, state, steps: Optional[Sequence[int]] = None):
    """``pre``: the four gate pre-activations (z, i, f, o), each (B, S, NH,
    Dh) f32; ``r``: the four recurrent weights, each (NH, Dh, Dh) in the
    parameter dtype (widened to f32, as the reference's ``.astype``);
    ``state``: (h, c, n, m), each (B, NH, Dh) f32 → ``(hs (B, S, NH, Dh)
    f32, stacks)``: ``stacks`` the state after each of ``steps``, with
    ``state`` left as it was; without ``steps``, None, and the state after
    the last step written into ``state`` in place.

    A CUDA input launches the kernel (or raises); a CPU input runs
    :func:`slstm_scan_plain`.
    """
    _check(pre, r, state)
    if not pre[0].is_cuda:
        return slstm_scan_plain(pre, r, state, steps)
    forward_only("slstm_scan", *pre, *r, *state)
    B, S, NH, Dh = pre[0].shape
    sel = check_steps(steps, S)
    update = steps is None
    pre = [t.contiguous() for t in pre]
    r = [w.contiguous() for w in r]
    st_in = [t.contiguous() for t in state]
    hs = torch.empty_like(pre[0])
    st_out = st_in if update else [None] * 4
    n_sel = len(sel)
    stacks = {name: t.new_empty((n_sel, *t.shape)) for name, t in zip(STATE, st_in)}
    sel_t = torch.tensor(sel, dtype=torch.int32, device=hs.device) if n_sel else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pl = plan(Dh, r[0].dtype) if Dh > 0 else None
    cl, rb = (pl.cl, min(B, pl.rb)) if pl and B > 0 else (1, 1)
    lib, fn = _entry()
    with torch.cuda.device(hs.device):
        rc = fn(*(t.data_ptr() for t in pre), *(w.data_ptr() for w in r), DTYPE_CODES[r[0].dtype],
                *(t.data_ptr() for t in st_in), hs.data_ptr(), *(ptr(t) for t in st_out), ptr(sel_t), n_sel,
                *(stacks[name].data_ptr() for name in STATE), B, S, NH, Dh, cl, rb,
                torch.cuda.current_stream(hs.device).cuda_stream)
    _build.check(lib, rc, "slstm_scan launch")
    slstm_scan.launches += 1
    if update:
        for dst, src in zip(state, st_in):
            if dst.data_ptr() != src.data_ptr() or not dst.is_contiguous():
                dst.copy_(src)
    return hs, (stacks if steps is not None else None)


slstm_scan.launches = 0
