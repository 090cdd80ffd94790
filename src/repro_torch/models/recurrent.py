"""Griffin's recurrent block, RG-LRU (counterpart of the RG-LRU part of
``repro/models/recurrent.py``; the xLSTM cells are not ported).

The block has a parallel form for a prompt or a speculative verify (the
recurrence scanned over the sequence by the hand-written kernel K9,
``kernels/rglru_scan.py``) and the same code at S = 1 for a decode step,
so a scan of S tokens gives each token the bits of S decode steps: every
operation around the scan is elementwise, the linears give a row the same
bits in a prompt and alone (``utils.matmul_rows``, the kernels), and K9
rounds the product and the sum of each step as the plain loop does.

Every cast sits where the reference puts it: ``w_y``, ``w_a`` and ``w_i``
produce f32, ``w_x`` the compute dtype; the gates, ``a`` and the gated
input are f32; the scan's output is cast to the compute dtype, widened to
f32 for the gate product, and that product cast back before ``w_out``.
``jax.nn.gelu`` is the tanh approximation.

The decoding state of a layer is ``{"h": (B, W) f32, "conv": (B, K-1, W)}``
in the compute dtype. The port updates caches in place: :func:`rglru_block`
copies the new state into the state's own tensors, so a captured decode
step (``infer/graphs.py``) replays against the live state. With
``collect=True`` (a speculative verify, or a prefill whose boundary states
a prefix cache commits) it leaves the state as it was and returns the
per-token stacks instead, ``h`` (S, B, W) and ``conv`` (S, B, K-1, W):
entry ``t`` is the state after token ``t``, from which a rollback picks the
one at the commit index (``infer/speculative.py``).

References: Griffin [arXiv:2402.19427] eqs. (1)-(4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import current_impl_mode, linear
from repro_torch.kernels.rglru_scan import rglru_scan as scan_kernel
from repro_torch.kernels.rglru_scan import rglru_scan_plain
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


def rglru_block(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[dict] = None,
    collect: bool = False,
    chunked: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Griffin recurrent block. x (B, S, D); ``state`` a layer's
    ``{"h": (B, W), "conv": (B, K-1, W)}`` views, updated in place (module
    docstring) and returned; None (train) keeps no state.

    ``collect=True`` leaves ``state`` untouched and returns the per-token
    stacks ``{"h": (S, B, W) f32, "conv": (S, B, K-1, W)}``, entry ``t``
    the state after token ``t``. ``chunked``: the tokens are a speculative
    verify's, and every linear sees them as token rows."""
    if collect and state is None:
        raise ValueError("collect=True requires a decoding state")
    gate = F.gelu(_linear(x, p["w_y"], chunked, out_dtype=torch.float32), approximate="tanh")
    u = _linear(x, p["w_x"], chunked)
    conv_state = state["conv"] if state is not None else None
    conv_in, s_len, kw = u, u.shape[1], p["conv_w"].shape[0]
    u, new_conv = _causal_conv1d(u, p["conv_w"], conv_state)
    h0 = state["h"] if state is not None else None
    y, h_last, hs = rglru_scan(p, u, h0, chunked)
    out = _linear((y.to(torch.float32) * gate).to(x.dtype), p["w_out"], chunked)
    if collect:
        # conv state after token t = the K-1 inputs ending at t
        xp = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)  # (B, S+K-1, W)
        widx = torch.arange(s_len, device=x.device)[:, None] + 1 + torch.arange(kw - 1, device=x.device)[None]
        conv_stack = xp[:, widx].permute(1, 0, 2, 3)  # (S, B, K-1, W)
        return out, {"h": hs.permute(1, 0, 2), "conv": conv_stack.to(conv_state.dtype)}
    if state is not None:
        state["h"].copy_(h_last)
        state["conv"].copy_(new_conv)
    return out, state


__all__ = ["init_rglru", "rglru_block", "rglru_scan"]
