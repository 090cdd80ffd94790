"""Recurrent temporal-mixing blocks: Griffin's RG-LRU and the xLSTM cells,
mLSTM (matrix memory) and sLSTM (scalar memory) (counterpart of
``repro/models/recurrent.py``).

Every block has a parallel form for a prompt or a speculative verify (the
recurrence scanned over the sequence by a hand-written kernel: K9
``kernels/rglru_scan.py``, K10 ``kernels/mlstm_scan.py``, K11
``kernels/slstm_scan.py``) and the same code at S = 1 for a decode step,
so a scan of S tokens gives each token the bits of S decode steps: every
operation around the scan is elementwise, the linears give a row the same
bits in a prompt and alone (``utils.matmul_rows``, the kernels), and the
scans round each step's products and sums as their plain loops do, in an
order set by the widths alone. Under ``impl_mode("ref")`` (the oracle
path) and for CPU tensors the scans run their plain loops.

Every cast sits where the reference puts it. RG-LRU: ``w_y``, ``w_a`` and
``w_i`` produce f32, ``w_x`` the compute dtype; the gates, ``a`` and the
gated input are f32; the scan's output is cast to the compute dtype,
widened to f32 for the gate product, and that product cast back before
``w_out``. ``jax.nn.gelu`` is the tanh approximation. mLSTM: ``w_up``
produces the compute dtype, ``w_z``, ``wq``, ``wk``, ``wv`` and the dense
f32 gates ``w_i`` / ``w_f`` (cast to x's dtype inside ``linear``) f32; the
skip term and ``silu(z)`` are f32, cast back before ``w_down``. sLSTM: the
four gate projections produce f32, the recurrent ``r_*`` are widened to
f32, the scan's output is cast to the compute dtype before ``w_out``.

Decoding state of a layer: RG-LRU ``{"h": (B, W) f32, "conv": (B, K-1, W)}``
in the compute dtype; mLSTM ``{"c": (B, NH, Dh, Dh), "n": (B, NH, Dh), "m":
(B, NH)}`` f32 (Dh = d_model · mlstm_proj_factor / NH); sLSTM ``{"h", "c",
"n", "m"}``, each (B, NH, Dh) f32 (Dh = d_model / NH). The xLSTM cells start
from ``m = -inf`` and, in the sLSTM, ``n = 1e-6`` (``models/model.py::
init_cache``). The port updates caches in place: a block writes the new
state into the state's own tensors, so a captured decode step
(``infer/graphs.py``) replays against the live state. With ``collect``
(a speculative verify, or a prefill whose boundary states a prefix cache
commits) it leaves the state as it was and returns per-token stacks
instead, ``(S', B, ...)`` a leaf: entry ``j`` is the state after token ``j``
(``collect=True``) or after the j-th of the steps ``collect`` names (a
sequence of step indices, so that a long prompt keeps only the states its
caller will read), from which a rollback or a snapshot picks
(``infer/speculative.py``, ``infer/engine.py``).

References: Griffin [arXiv:2402.19427] eqs. (1)-(4); xLSTM
[arXiv:2405.04517] §2 (sLSTM) and §3 (mLSTM), with exponential gating
stabilised in log space.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_scan import mlstm_scan as mlstm_kernel
from repro_torch.kernels.mlstm_scan import mlstm_scan_plain, scale_for
from repro_torch.kernels.ops import current_impl_mode, linear
from repro_torch.kernels.rglru_scan import rglru_scan as scan_kernel
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.kernels.slstm_scan import GATES, sigmoid
from repro_torch.kernels.slstm_scan import slstm_scan as slstm_kernel
from repro_torch.kernels.slstm_scan import slstm_scan_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, token_rows_view

_C_RGLRU = 8.0  # Griffin's fixed recurrence-sharpness constant


def init_rglru(gen: torch.Generator, cfg: ModelConfig, lead=(), device="cuda") -> dict:
    """Random RG-LRU parameters (the reference's shapes, dtypes and scales;
    ``lam`` such that ``a = σ(Λ)^(c·r)`` starts with a decay in [0.9, 0.999])."""
    d, w, pd = cfg.d_model, cfg.lru_width, cfg.pdtype
    lo, hi = 0.9**_C_RGLRU, 0.999**_C_RGLRU
    u = torch.rand((*lead, w), generator=gen, dtype=torch.float32, device=device) * (hi - lo) + lo
    root = u ** (1.0 / _C_RGLRU)
    conv = torch.randn((*lead, cfg.conv_width, w), generator=gen, dtype=torch.float32, device=device)
    return {
        "w_x": _dense_init(gen, (*lead, d, w), d, pd, device),  # recurrent branch in
        "w_y": _dense_init(gen, (*lead, d, w), d, pd, device),  # gate branch in
        "conv_w": (conv * 0.1).to(pd),
        "w_a": _dense_init(gen, (*lead, w, w), w, pd, device),  # recurrence gate
        "w_i": _dense_init(gen, (*lead, w, w), w, pd, device),  # input gate
        "lam": torch.log(root / (1 - root)),  # (w,) f32
        "w_out": _dense_init(gen, (*lead, w, d), w, pd, device),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv. x (B, S, W); w (K, W); state (B, K-1, W) or
    None (zeros) → (out (B, S, W), the new state: the last K-1 inputs). The
    taps are summed in order, ``t0 + t1 + ...``, in x's dtype."""
    kw, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], kw - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, W)
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, kw):
        out = out + xp[:, i : i + s] * w[i].to(x.dtype)
    return out, xp[:, -(kw - 1):]


def _scan(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor):
    """K9 on the card (the plain loop under ``impl_mode("ref")``, the oracle
    path, and for CPU tensors)."""
    if current_impl_mode() == "ref":
        return rglru_scan_plain(a, g, h0)
    return scan_kernel(a, g, h0)


def _linear(x: torch.Tensor, w, chunked: bool, **kw) -> torch.Tensor:
    """``linear`` of x (B, S, k); ``chunked`` (a speculative verify) runs
    each token as a row of its own (``layers.token_rows_view``), as a decode
    step's rows run."""
    if not chunked:
        return linear(x, w, **kw)
    return linear(token_rows_view(x), w, **kw).reshape(*x.shape[:-1], -1)


def rglru_scan(p: dict, x: torch.Tensor, h0: Optional[torch.Tensor], chunked: bool = False):
    """RG-LRU over a sequence. x (B, S, W) after the conv. Returns (y (B, S, W)
    in x's dtype, h_last (B, W) f32, hs (B, S, W) f32: the state after each
    token).

    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
    a_t = exp(c · r_t · log σ(Λ)), r_t = σ(x_t W_a), i_t = σ(x_t W_i)."""
    b, _, w = x.shape
    r = torch.sigmoid(_linear(x, p["w_a"], chunked, out_dtype=torch.float32))
    i = torch.sigmoid(_linear(x, p["w_i"], chunked, out_dtype=torch.float32))
    log_a = _C_RGLRU * r * F.logsigmoid(p["lam"].to(torch.float32))
    a = torch.exp(log_a)  # (B, S, W) in (0, 1)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.to(torch.float32))
    if h0 is None:
        h0 = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    hs, h_last = _scan(a, gated, h0)
    return hs.to(x.dtype), h_last, hs


Collect = Union[bool, Sequence[int]]


def collect_steps(collect: Collect, s: int) -> Optional[Tuple[int, ...]]:
    """The steps whose state a block returns: None (no collecting: the state
    is updated in place), every step for ``collect=True``, else the given
    step indices (ascending, distinct, in [0, s))."""
    if collect is True:
        return tuple(range(s))
    if collect is False or collect is None:
        return None
    return tuple(int(t) for t in collect)


def rglru_block(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[dict] = None,
    collect: Collect = False,
    chunked: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Griffin recurrent block. x (B, S, D); ``state`` a layer's
    ``{"h": (B, W), "conv": (B, K-1, W)}`` views, updated in place (module
    docstring) and returned; None (train) keeps no state.

    ``collect`` (True, or step indices) leaves ``state`` untouched and
    returns the per-token stacks ``{"h": (S', B, W) f32, "conv": (S', B,
    K-1, W)}`` (module docstring). ``chunked``: the tokens are a speculative
    verify's, and every linear sees them as token rows."""
    steps = collect_steps(collect, x.shape[1])
    if steps is not None and state is None:
        raise ValueError("collect=True requires a decoding state")
    gate = F.gelu(_linear(x, p["w_y"], chunked, out_dtype=torch.float32), approximate="tanh")
    u = _linear(x, p["w_x"], chunked)
    conv_state = state["conv"] if state is not None else None
    conv_in, kw = u, p["conv_w"].shape[0]
    u, new_conv = _causal_conv1d(u, p["conv_w"], conv_state)
    h0 = state["h"] if state is not None else None
    y, h_last, hs = rglru_scan(p, u, h0, chunked)
    out = _linear((y.to(torch.float32) * gate).to(x.dtype), p["w_out"], chunked)
    if steps is not None:
        # conv state after token t = the K-1 inputs ending at t
        xp = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)  # (B, S+K-1, W)
        at = torch.tensor(steps, dtype=torch.long, device=x.device)
        widx = at[:, None] + 1 + torch.arange(kw - 1, device=x.device)[None]
        conv_stack = xp[:, widx].permute(1, 0, 2, 3)  # (S', B, K-1, W)
        return out, {"h": hs[:, at].permute(1, 0, 2), "conv": conv_stack.to(conv_state.dtype)}
    if state is not None:
        state["h"].copy_(h_last)
        state["conv"].copy_(new_conv)
    return out, state


# ---------------------------------------------------------------------------
# the xLSTM cells (xLSTM §2, §3): mLSTM matrix memory, sLSTM scalar memory
# ---------------------------------------------------------------------------

# Initial values of the xLSTM cells' state leaves (the reference's
# ``init_block_cache``); every other cache leaf starts at 0. ``init_cache``,
# a block run without a state and every reset of a cache take them from here
# (``models/model.py::reset_cache``).
INITIAL_VALUES = {"mlstm": {"m": -math.inf}, "slstm": {"n": 1e-6, "m": -math.inf}}


def initial_value(btype: str, name: str) -> float:
    return INITIAL_VALUES.get(btype, {}).get(name, 0.0)


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(inner width, head width Dh) of the mLSTM block."""
    inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    return inner, inner // cfg.n_heads


def state_shapes(cfg: ModelConfig, btype: str, batch: int) -> dict:
    """Leaf name → shape of one layer's xLSTM state (all f32)."""
    nh = cfg.n_heads
    if btype == "mlstm":
        dh = mlstm_dims(cfg)[1]
        return {"c": (batch, nh, dh, dh), "n": (batch, nh, dh), "m": (batch, nh)}
    dh = cfg.d_model // nh
    return {name: (batch, nh, dh) for name in ("h", "c", "n", "m")}


def init_state(cfg: ModelConfig, btype: str, batch: int, lead=(), device="cuda") -> dict:
    """A fresh xLSTM state at its initial values, ``lead + shape`` a leaf."""
    return {name: torch.full((*lead, *shape), initial_value(btype, name), dtype=torch.float32, device=device)
            for name, shape in state_shapes(cfg, btype, batch).items()}


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, lead=(), device="cuda") -> dict:
    """Random mLSTM parameters (the reference's shapes, dtypes and scales:
    the per-head gates ``w_i`` / ``w_f`` are f32, ``skip_scale`` ones)."""
    d, nh, pd = cfg.d_model, cfg.n_heads, cfg.pdtype
    inner = mlstm_dims(cfg)[0]
    return {
        "w_up": _dense_init(gen, (*lead, d, inner), d, pd, device),
        "w_z": _dense_init(gen, (*lead, d, inner), d, pd, device),  # output-gate branch
        "wq": _dense_init(gen, (*lead, inner, inner), inner, pd, device),
        "wk": _dense_init(gen, (*lead, inner, inner), inner, pd, device),
        "wv": _dense_init(gen, (*lead, inner, inner), inner, pd, device),
        "w_i": _dense_init(gen, (*lead, inner, nh), inner, torch.float32, device),  # input gate (per head)
        "w_f": _dense_init(gen, (*lead, inner, nh), inner, torch.float32, device),  # forget gate (per head)
        "w_down": _dense_init(gen, (*lead, inner, d), inner, pd, device),
        "skip_scale": torch.ones((*lead, inner), dtype=torch.float32, device=device),
    }


def init_slstm(gen: torch.Generator, cfg: ModelConfig, lead=(), device="cuda") -> dict:
    """Random sLSTM parameters (the reference's shapes, dtypes and scales:
    the recurrent ``r_*`` (NH, Dh, Dh) are N(0, 1/Dh))."""
    d, nh, pd = cfg.d_model, cfg.n_heads, cfg.pdtype
    dh = d // nh

    def rinit():
        w = torch.randn((*lead, nh, dh, dh), generator=gen, dtype=torch.float32, device=device)
        return (w / math.sqrt(dh)).to(pd)

    p = {f"w_{g}": _dense_init(gen, (*lead, d, d), d, pd, device) for g in GATES}
    p.update({f"r_{g}": rinit() for g in GATES})
    p["w_out"] = _dense_init(gen, (*lead, d, d), d, pd, device)
    return p


def _mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilised quadratic parallel form (train), the reference's.

    q, k, v (B, NH, S, Dh); i_gate, f_gate (B, NH, S) raw logits.
    D_ts = exp(i_s + Σ_{u=s+1..t} log σ(f_u) − m_t), causal; h = (D ⊙ qkᵀ) v / norm."""
    s, dh = q.shape[2], q.shape[3]
    logf = F.logsigmoid(f_gate)
    cf = torch.cumsum(logf, dim=-1)  # inclusive cumsum
    dmat = cf[..., :, None] - cf[..., None, :] + i_gate[..., None, :]  # cf[t] - cf[s] + i[s]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri, dmat, torch.tensor(-math.inf, device=q.device))
    m = dmat.amax(dim=-1, keepdim=True)  # stabiliser
    dmat = torch.exp(dmat - m)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) / torch.sqrt(torch.tensor(float(dh), device=q.device))
    weights = scores * dmat
    norm = torch.maximum(weights.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bhts,bhsd->bhtd", weights / norm, v)


MLSTM_CHUNK = 128  # chunkwise-parallel block length (train)


def _mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM (train), the reference's: intra-chunk
    quadratic, inter-chunk recurrent (C, n, m carried over the chunks), in
    O(S · chunk) memory. q, k, v (B, NH, S, Dh); i_gate, f_gate (B, NH, S)
    raw logits → h (B, NH, S, Dh)."""
    b, nh, s, dh = q.shape
    c = min(chunk, s)
    if s % c:
        pad = c - s % c
        zpad = lambda t: F.pad(t, (0, 0) * (t.dim() - 3) + (0, pad))  # noqa: E731
        out = _mlstm_chunkwise(zpad(q), zpad(k), zpad(v), zpad(i_gate),
                               F.pad(f_gate, (0, pad), value=30.0), chunk)  # σ(30) ≈ 1
        return out[:, :, :s]
    nc = s // c
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), device=q.device))
    qc = q.reshape(b, nh, nc, c, dh) * scale
    kc = k.reshape(b, nh, nc, c, dh)
    vc = v.reshape(b, nh, nc, c, dh)
    ic = i_gate.reshape(b, nh, nc, c)
    bcum = torch.cumsum(F.logsigmoid(f_gate).reshape(b, nh, nc, c), dim=-1)  # within-chunk logf cumsum
    a = ic - bcum  # a_s = i_s - b_s
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    c_st = q.new_zeros((b, nh, dh, dh))
    n_st = q.new_zeros((b, nh, dh))
    m_st = q.new_full((b, nh), -1e30)
    hs = []
    for j in range(nc):
        qt, kt, vt, it_, bt, at = (t[:, :, j] for t in (qc, kc, vc, ic, bcum, a))
        # stabiliser per position t: M_t = max(m_st + b_t, b_t + max_{s<=t} a_s)
        a_run = torch.cummax(at, dim=-1).values
        m_t = torch.maximum(m_st[..., None] + bt, bt + a_run)
        inter_w = torch.exp(bt + m_st[..., None] - m_t)  # decay of the carried state
        h_inter = torch.einsum("bhtd,bhde->bhte", qt, c_st) * inter_w[..., None]
        n_inter = torch.einsum("bhtd,bhd->bht", qt, n_st) * inter_w
        dlog = bt[..., :, None] - bt[..., None, :] + it_[..., None, :]
        dmat = torch.where(tri, torch.exp(dlog - m_t[..., :, None]), torch.zeros((), device=q.device))
        w = torch.einsum("bhtd,bhsd->bhts", qt, kt) * dmat
        h_intra = torch.einsum("bhts,bhsd->bhtd", w, vt)
        denom = torch.maximum((n_inter + w.sum(-1)).abs(), torch.exp(-m_t))
        hs.append((h_inter + h_intra) / denom[..., None])
        # the state at the chunk's end
        b_c = bt[..., -1]
        m_new = torch.maximum(m_st + b_c, b_c + a_run[..., -1])
        decay = torch.exp(m_st + b_c - m_new)
        kw = torch.exp(b_c[..., None] - bt + it_ - m_new[..., None])
        c_st = decay[..., None, None] * c_st + torch.einsum("bhs,bhsd,bhse->bhde", kw, kt, vt)
        n_st = decay[..., None] * n_st + torch.einsum("bhs,bhsd->bhd", kw, kt)
        m_st = m_new
    return torch.stack(hs, dim=2).reshape(b, nh, s, dh)


def _mlstm_scan(*args, **kw):
    """K10 on the card (the plain loop under ``impl_mode("ref")`` and for
    CPU tensors)."""
    if current_impl_mode() == "ref":
        return mlstm_scan_plain(*args, **kw)
    return mlstm_kernel(*args, **kw)


def _slstm_scan(*args, **kw):
    """K11 on the card (the plain loop under ``impl_mode("ref")`` and for
    CPU tensors)."""
    if current_impl_mode() == "ref":
        return slstm_scan_plain(*args, **kw)
    return slstm_kernel(*args, **kw)


def mlstm_block(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[dict] = None,
    collect: Collect = False,
    chunked: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The mLSTM block. x (B, S, D); ``state`` a layer's ``{"c", "n", "m"}``
    views, updated in place and returned; None (train) keeps no state and,
    for S > 1, takes the reference's quadratic (S <= ``MLSTM_CHUNK``) or
    chunkwise form. ``collect`` (True, or step indices) leaves ``state``
    untouched and returns the stacks ``{"c": (S', B, NH, Dh, Dh), "n": (S',
    B, NH, Dh), "m": (S', B, NH)}`` (module docstring). ``chunked``: the
    tokens are a speculative verify's, and every linear sees them as token
    rows."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    inner, dh = mlstm_dims(cfg)
    steps = collect_steps(collect, s)
    if steps is not None and state is None:
        raise ValueError("collect=True requires a decoding state")
    f32 = torch.float32
    u = _linear(x, p["w_up"], chunked)
    z = _linear(x, p["w_z"], chunked, out_dtype=f32)
    q, k, v = (_linear(u, p[w], chunked, out_dtype=f32).reshape(b, s, nh, dh) for w in ("wq", "wk", "wv"))
    i_gate = _linear(u, p["w_i"], chunked, out_dtype=f32)  # (B, S, NH)
    f_gate = _linear(u, p["w_f"], chunked, out_dtype=f32)
    if state is None and s > 1:
        form = _mlstm_parallel if s <= MLSTM_CHUNK else _mlstm_chunkwise
        heads = lambda t: t.transpose(1, 2)  # noqa: E731  (B, NH, S, ...)
        h = heads(form(heads(q), heads(k), heads(v), heads(i_gate), heads(f_gate)))
        ret = None
    else:
        st = state if state is not None else init_state(cfg, "mlstm", b, device=x.device)
        h, stacks = _mlstm_scan(q, k, v, i_gate, F.logsigmoid(f_gate), st["c"], st["n"], st["m"], scale_for(dh),
                                steps=steps)
        ret = stacks if steps is not None else state
    h = h.reshape(b, s, inner) + p["skip_scale"] * u.to(f32)
    out = _linear((h * (z * sigmoid(z))).to(x.dtype), p["w_down"], chunked)
    return out, ret


def slstm_block(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[dict] = None,
    collect: Collect = False,
    chunked: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The sLSTM block: strictly sequential, so train runs the scan too. x
    (B, S, D); ``state`` a layer's ``{"h", "c", "n", "m"}`` views, updated
    in place and returned; None (train) starts from the initial values and
    keeps no state. ``collect`` (True, or step indices) leaves ``state``
    untouched and returns the stacks ``{"h", "c", "n", "m"}``, each (S', B,
    NH, Dh) (module docstring). ``chunked``: the tokens are a speculative
    verify's, and every linear sees them as token rows."""
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    steps = collect_steps(collect, s)
    if steps is not None and state is None:
        raise ValueError("collect=True requires a decoding state")
    pre = [_linear(x, p["w_" + g], chunked, out_dtype=torch.float32).reshape(b, s, nh, dh) for g in GATES]
    st = state if state is not None else init_state(cfg, "slstm", b, device=x.device)
    hs, stacks = _slstm_scan(pre, [p["r_" + g] for g in GATES], [st[name] for name in ("h", "c", "n", "m")],
                             steps=steps)
    out = _linear(hs.reshape(b, s, d).to(x.dtype), p["w_out"], chunked)
    return out, (stacks if steps is not None else state)


__all__ = ["init_mlstm", "init_rglru", "init_slstm", "init_state", "mlstm_block", "rglru_block", "rglru_scan",
           "slstm_block"]
