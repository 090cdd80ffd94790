"""The mLSTM scan (K10): the xLSTM matrix-memory cell over a sequence, for
every (batch row, head), from its state ``c`` (Dh × Dh), ``n`` and ``m``.

It replaces no ``pallas_call``: it is the port's counterpart of the
reference's ``lax.scan`` over the mLSTM step
(``src/repro/models/recurrent.py:293-317``), which serves every prefill,
decode step and speculative verify of an xLSTM model, and which as eager
PyTorch on the card would be S steps of 10-20 launches a layer. The CUDA
kernel is ``csrc/mlstm_scan.cu``: one block per (row, head, 16-column tile
of C) (:func:`plan`), C in registers over the sequence, the inputs staged
ahead in a ring of shared memory by a producer warp (TMA bulk copies, or
per-element ``cp.async`` where a row is not a 16-byte multiple), ``qᵀC``
and ``qᵀn`` summed in an order set by Dh alone, products and sums rounded
separately, so a row's bits depend on its own values alone and a scan of S
steps equals S decode steps (S = 1).

:func:`mlstm_scan` launches the kernel for CUDA tensors (or raises: there
is no fallback) and runs :func:`mlstm_scan_plain` for CPU tensors; the
``impl_mode("ref")`` path calls the plain version itself
(``models/recurrent.py``). ``mlstm_scan.launches`` counts kernel launches.

``steps`` (ascending step indices) asks for the state after each of those
steps, ``{"c": (n, B, NH, Dh, Dh), "n": (n, B, NH, Dh), "m": (n, B, NH)}``,
and leaves the state as it was: a speculative verify keeps every step, a
prefill whose prefix blocks are committed only the block boundaries and its
last step, so a long prompt never holds a matrix memory per token (14.2 MB
a token and row at xlstm-125m's width). Without ``steps`` the state after
the last step is written in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import forward_only
from repro_torch.utils import row_sum

MAX_DH = 512  # csrc/mlstm_scan.cu::MAX_DH
GROUPS = 8  # row groups of C, each summed in row order (csrc: kGroups)
TILE = 16  # columns of C a block (csrc: kTile)
STEPS = 8  # steps a ring stage holds (csrc: kSteps)
MAX_STAGES = 4
SM_SMEM = 233472  # shared memory of one SM (228 KB), 1 KB of it reserved a block
BLOCKS_PER_SM = 3  # decode launches keep three blocks an SM in flight


def row_stride(Dh: int) -> int:
    """Floats of a staged row: the 8 row groups of ``ceil(Dh / 8)`` rows,
    rounded up to 16 bytes (``csrc/mlstm_scan.cu::row_stride``)."""
    return -(-GROUPS * -(-Dh // GROUPS) // 4) * 4


def smem_bytes(Dh: int, stages: int) -> int:
    """A block's shared memory (``csrc/mlstm_scan.cu::smem_bytes``): each
    stage q and k [STEPS][row_stride], v [STEPS][TILE], four gate values a
    step and h's partials, acc [STEPS][GROUPS][TILE] and qn
    [STEPS][GROUPS], all f32, and three mbarriers; kk [STEPS][row_stride]."""
    rs = row_stride(Dh)
    stage = 2 * STEPS * rs + STEPS * TILE + 4 * STEPS + STEPS * GROUPS * TILE + STEPS * GROUPS
    return 4 * (stages * stage + STEPS * rs) + 24 * stages


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch shape for one head width: ``tile`` columns of C
    a block, a ring of ``stages`` stages of ``steps`` steps in ``smem``
    bytes; ``bulk``: rows are 16-byte multiples, so TMA bulk copies fill the
    ring (else per-element ``cp.async`` copies, in the same kernel). It sets
    no sum's order: that is the row groups', set by Dh alone."""

    Dh: int
    tile: int
    steps: int
    stages: int
    smem: int
    bulk: bool

    def grid(self, B: int, NH: int) -> Tuple[int, int, int]:
        return (-(-self.Dh // self.tile), NH, B)

    def blocks(self, B: int, NH: int) -> int:
        x, y, z = self.grid(B, NH)
        return x * y * z


@functools.lru_cache(maxsize=None)
def plan(Dh: int) -> Plan:
    """16 columns a block, so xlstm-125m's 4 heads of Dh 384 give 96 blocks at
    B = 1; the most stages (2 to ``MAX_STAGES``) that leave
    ``BLOCKS_PER_SM`` blocks an SM; bulk copies where ``4 Dh`` is a
    multiple of 16. Depends on Dh alone, never on B or S."""
    if not 0 <= Dh <= MAX_DH:
        raise ValueError(f"mlstm_scan: Dh {Dh} must be in 0..{MAX_DH}")
    fits = [s for s in range(2, MAX_STAGES + 1) if BLOCKS_PER_SM * (smem_bytes(Dh, s) + 1024) <= SM_SMEM]
    stages = max(fits, default=2)
    return Plan(Dh=Dh, tile=TILE, steps=STEPS, stages=stages, smem=smem_bytes(Dh, stages), bulk=Dh % 4 == 0)


def use_bulk(pl: Plan, *rows: torch.Tensor) -> bool:
    """Whether a launch fills the ring by bulk copies: the plan's rows are
    16-byte multiples and ``rows`` (q, k, v) start on 16-byte boundaries;
    else the kernel's per-element ``cp.async`` path."""
    return pl.bulk and all(t.data_ptr() % 16 == 0 for t in rows)


@functools.lru_cache(maxsize=None)
def scale_for(dh: int) -> float:
    """The key scale ``1 / sqrt(Dh)`` as the reference computes it, in f32
    (``1.0 / jnp.sqrt(jnp.float32(dh))``): a Python float that is exactly
    that f32 value."""
    return (1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))).item()


def check_steps(steps: Optional[Sequence[int]], S: int) -> Tuple[int, ...]:
    """``steps`` as a tuple of ascending, distinct indices in [0, S), or raise."""
    if steps is None:
        return ()
    steps = tuple(int(t) for t in steps)
    if any(not 0 <= t < S for t in steps) or any(a >= b for a, b in zip(steps, steps[1:])):
        raise ValueError(f"steps must be ascending, distinct indices in [0, {S}), got {steps}")
    return steps


def mlstm_scan_plain(q, k, v, i_gate, logf, c, n, m, scale: float, steps: Optional[Sequence[int]] = None):
    """The plain PyTorch version: the reference's step for t in order (see
    :func:`mlstm_scan`), its dot products summed with
    :func:`~repro_torch.utils.row_sum`, whose result for one row does not
    depend on the batch. Same arguments and results as :func:`mlstm_scan`."""
    S = q.shape[1]
    keep = set(check_steps(steps, S))
    hs, kept = [], []
    # from copies: c, n, m take the last step's values in place below, and a
    # backward reads the first step's inputs (see slstm_scan_plain)
    cc, nn, mm = c.clone(), n.clone(), m.clone()
    for t in range(S):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]  # (B, NH, Dh)
        lm = logf[:, t] + mm
        m_new = torch.maximum(lm, i_gate[:, t])
        fg = torch.exp(lm - m_new)  # (B, NH)
        ig = torch.exp(i_gate[:, t] - m_new)
        kk = ig[..., None] * k_t * scale
        cc = fg[..., None, None] * cc + kk[..., :, None] * v_t[..., None, :]
        nn = fg[..., None] * nn + kk
        num = row_sum((q_t[..., :, None] * cc).transpose(-1, -2))[..., 0]  # Σ_d q[d] C[d, e]
        den = torch.maximum(row_sum(q_t * nn)[..., 0].abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        mm = m_new
        if t in keep:
            kept.append((cc, nn, mm))
    h = torch.stack(hs, dim=1) if hs else q.new_zeros(q.shape)
    if steps is not None:
        return h, _stacks(kept, c, n, m)
    c.copy_(cc)
    n.copy_(nn)
    m.copy_(mm)
    return h, None


def _stacks(kept, c, n, m) -> dict:
    if not kept:
        return {"c": c.new_zeros((0, *c.shape)), "n": n.new_zeros((0, *n.shape)), "m": m.new_zeros((0, *m.shape))}
    return {name: torch.stack([st[i] for st in kept]) for i, name in enumerate(("c", "n", "m"))}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("mlstm_scan")
    fn = lib.mlstm_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [p, i, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
    fn.restype = i
    return lib, fn


def _check(q, k, v, i_gate, logf, c, n, m) -> None:
    if q.dim() != 4:
        raise ValueError(f"mlstm_scan: q must be (B, S, NH, Dh), got {tuple(q.shape)}")
    B, S, NH, Dh = q.shape
    want = {"q": (B, S, NH, Dh), "k": (B, S, NH, Dh), "v": (B, S, NH, Dh), "i_gate": (B, S, NH),
            "logf": (B, S, NH), "c": (B, NH, Dh, Dh), "n": (B, NH, Dh), "m": (B, NH)}
    for name, t in zip(want, (q, k, v, i_gate, logf, c, n, m)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mlstm_scan: {name} {tuple(t.shape)} must be {want[name]} "
                             "(q, k, v (B, S, NH, Dh); gates (B, S, NH); c, n, m the state)")
        if t.dtype != torch.float32:
            raise TypeError(f"mlstm_scan: {name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"mlstm_scan: {name} is on {t.device}, q on {q.device}")
    if Dh > MAX_DH:
        raise ValueError(f"mlstm_scan: Dh {Dh} exceeds the kernel's {MAX_DH}")


def mlstm_scan(q, k, v, i_gate, logf, c, n, m, scale: float, steps: Optional[Sequence[int]] = None):
    """``q``, ``k``, ``v`` (B, S, NH, Dh) f32, ``i_gate`` and ``logf = log
    σ(f)`` (B, S, NH) f32, the state ``c`` (B, NH, Dh, Dh), ``n`` (B, NH,
    Dh), ``m`` (B, NH) f32 and the key scale → ``(h (B, S, NH, Dh) f32,
    stacks)``: ``stacks`` the state after each of ``steps``, with ``c``,
    ``n`` and ``m`` left as they were; without ``steps``, None, and the
    state after the last step written into ``c``, ``n`` and ``m`` in place.

    A CUDA input launches the kernel (or raises); a CPU input runs
    :func:`mlstm_scan_plain`.
    """
    _check(q, k, v, i_gate, logf, c, n, m)
    if not q.is_cuda:
        return mlstm_scan_plain(q, k, v, i_gate, logf, c, n, m, scale, steps)
    forward_only("mlstm_scan", q, k, v, i_gate, logf, c, n, m)
    B, S, NH, Dh = q.shape
    sel = check_steps(steps, S)
    update = steps is None
    q, k, v, i_gate, logf = (t.contiguous() for t in (q, k, v, i_gate, logf))
    c_in, n_in, m_in = c.contiguous(), n.contiguous(), m.contiguous()
    h = torch.empty_like(q)
    n_out, m_out = torch.empty_like(n_in), torch.empty_like(m_in)
    c_out = c_in if update else None
    n_sel = len(sel)
    stacks = {"c": c_in.new_empty((n_sel, *c_in.shape)), "n": n_in.new_empty((n_sel, *n_in.shape)),
              "m": m_in.new_empty((n_sel, *m_in.shape))}
    sel_t = torch.tensor(sel, dtype=torch.int32, device=q.device) if n_sel else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pl = plan(Dh)
    bulk = use_bulk(pl, q, k, v)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), logf.data_ptr(), c_in.data_ptr(),
                n_in.data_ptr(), m_in.data_ptr(), h.data_ptr(), ptr(c_out), n_out.data_ptr(), m_out.data_ptr(),
                ptr(sel_t), n_sel, stacks["c"].data_ptr(), stacks["n"].data_ptr(), stacks["m"].data_ptr(),
                B, S, NH, Dh, scale, pl.stages, int(bulk), pl.smem,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "mlstm_scan launch")
    mlstm_scan.launches += 1
    if update:
        for dst, src in ((c, c_in), (n, n_out), (m, m_out)):
            if dst.data_ptr() != src.data_ptr() or not dst.is_contiguous():
                dst.copy_(src)
    return h, (stacks if steps is not None else None)


mlstm_scan.launches = 0
