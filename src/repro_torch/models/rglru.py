"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

The port of ``repro/models/rglru.py``. Block = (x-branch: linear ->
causal conv -> RG-LRU) gated by (y-branch: linear -> GELU), then the
output projection.

RG-LRU:  r_t = sigma(W_a u_t + b_a)         recurrence gate
         i_t = sigma(W_x u_t + b_x)         input gate
         a_t = exp(-c * softplus(Lambda) * r_t)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The causal conv goes through the conv1d kernel's wrapper (no activation).
The linear recurrence has no kernel in the reference (its
``jax.lax.associative_scan`` is plain JAX), so it stays plain torch:

* ``rglru_block`` (prefill) scans the sequence by recursive doubling
  (Hillis-Steele): at offset 1, 2, 4, ... each step folds the pair
  (a, b) ``offset`` steps back into every position, so S=2,560 takes 12
  steps of a few whole-tensor ops instead of a loop over S;
* ``rglru_steps`` runs the reference's one-token ``rglru_decode_step``
  over T tokens from a state, computing everything that does not depend
  on the state for all T at once and looping only ``h = a_t h + b_t``.
  ``rglru_decode_step`` is its T=1 case; the engine's chunked prefill and
  speculative verify call it with T>1, the verify asking for the state
  after every token.

jax.nn.gelu defaults to the tanh approximation, so the port uses
``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.conv1d.ref import tail_snapshots


def rglru_shapes(cfg: ModelConfig):
    """{leaf: (shape, init, scale)} of one block, the reference's
    ``rglru_params`` layout and init law."""
    g = cfg.rglru
    d = cfg.d_model
    w = g.lru_width or d
    return {
        "w_x": ((d, w), "normal", None),
        "w_y": ((d, w), "normal", None),
        "conv_w": ((g.conv_width, w), "normal", None),
        "conv_b": ((w,), "zeros", None),
        "wa": ((w, w), "normal", None),
        "ba": ((w,), "zeros", None),
        "wi": ((w, w), "normal", None),
        "bi": ((w,), "zeros", None),
        "lam": ((w,), "uniform", 1.0),
        "w_out": ((w, d), "normal", None),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) recurrent state, float32
    conv: torch.Tensor       # (B, K-1, W) conv tail, float32


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> RGLRUState:
    g = cfg.rglru
    w = g.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=dtype, device=device),
        conv=torch.zeros((batch, g.conv_width - 1, w), dtype=dtype,
                         device=device))


def _conv(params, cfg: ModelConfig, u: torch.Tensor,
          tail: Optional[torch.Tensor] = None, *, conv=causal_conv1d):
    """Depthwise causal conv (bias, no activation) through the conv1d
    kernel's wrapper. Returns (conv(u), new tail in u's dtype)."""
    w = params["conv_w"].to(u.dtype)
    b = params["conv_b"].to(u.dtype)
    if tail is not None:
        tail = tail.to(u.dtype).contiguous()
    return conv(u.contiguous(), w.contiguous(), b.contiguous(),
                activation="none", tail=tail)


def _gates(params, cfg: ModelConfig, u: torch.Tensor):
    """u (B,S,W) -> (a (float32), gated input b (float32)) per step."""
    c = cfg.rglru.c_constant
    r = torch.sigmoid(u @ params["wa"].to(u.dtype)
                      + params["ba"].to(u.dtype)).float()
    i = torch.sigmoid(u @ params["wi"].to(u.dtype)
                      + params["bi"].to(u.dtype)).float()
    log_a = -c * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    return a, b


def _branches(params, cfg: ModelConfig, x: torch.Tensor):
    """x (B,S,d) -> (u before the conv, GELU gate)."""
    u = x @ params["w_x"].to(x.dtype)
    y_gate = F.gelu(x @ params["w_y"].to(x.dtype), approximate="tanh")
    return u, y_gate


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, by recursive
    doubling: ceil(log2 S) steps, each combining (a, b) at t with the pair
    ``offset`` steps back, as the reference's associative scan combines
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``."""
    S = a.shape[1]
    offset = 1
    while offset < S:
        b = torch.cat([b[:, :offset], a[:, offset:] * b[:, :-offset]
                       + b[:, offset:]], dim=1)
        a = torch.cat([a[:, :offset], a[:, offset:] * a[:, :-offset]], dim=1)
        offset *= 2
    return b


def rglru_block(params, cfg: ModelConfig, x: torch.Tensor, *,
                conv=causal_conv1d):
    """Whole-prompt Griffin recurrent block, collecting its state (the
    reference's ``return_state=True``). x (B,S,d) -> (out (B,S,d),
    RGLRUState float32)."""
    u, y_gate = _branches(params, cfg, x)
    u, tail = _conv(params, cfg, u, conv=conv)
    a, b = _gates(params, cfg, u)
    h = linear_scan(a, b).to(x.dtype)
    out = (h * y_gate) @ params["w_out"].to(x.dtype)
    return out, RGLRUState(h=h[:, -1].float(), conv=tail.float())


def rglru_steps(params, cfg: ModelConfig, x: torch.Tensor,
                state: RGLRUState, *, snapshots: bool = False,
                conv=causal_conv1d):
    """The reference's one-token ``rglru_decode_step`` applied to each of
    the T tokens of x (B,T,d) in turn, from ``state``. Returns (out
    (B,T,d), the state after the last token), or with ``snapshots`` the
    state after EVERY token, stacked on a leading T axis."""
    T = x.shape[1]
    K = cfg.rglru.conv_width
    u_raw, y_gate = _branches(params, cfg, x)
    u, tail = _conv(params, cfg, u_raw, tail=state.conv, conv=conv)
    a, b = _gates(params, cfg, u)                               # (B,T,W) float32
    h = state.h
    hs = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    hseq = torch.stack(hs, dim=1)                               # (B,T,W) float32
    out = (hseq.to(x.dtype) * y_gate) @ params["w_out"].to(x.dtype)
    if snapshots:
        tails = tail_snapshots(u_raw, state.conv, K).float()
        return out, RGLRUState(h=hseq.transpose(0, 1), conv=tails)
    return out, RGLRUState(h=h, conv=tail.float())


def rglru_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                      state: RGLRUState, *, conv=causal_conv1d):
    """One-token step. x (B,1,d) -> (out (B,1,d), new state)."""
    return rglru_steps(params, cfg, x, state, conv=conv)
