"""Mamba-2 SSD block [arXiv:2405.21060]: whole-prompt dual form and the
recurrent step.

The port of ``repro/models/ssm.py``. Shapes: x (B,S,H,P) heads/headdim,
B/C (B,S,G,N) groups/state, dt (B,S,H), A (H,) negative decay.

* ``ssm_block`` (prefill) runs the causal conv through the conv1d
  kernel's wrapper and the chunked dual form ``ssd_chunked``, whose
  intra-chunk steps 1-2 go through the SSD-chunk kernel's wrapper (it
  builds the decay mask itself, so no ``_segsum`` is needed). The
  inter-chunk scan and the state-to-output term stay plain torch, as in
  the reference.
* ``ssm_steps`` runs the recurrent form over T tokens from a state: the
  reference's ``ssm_decode_step`` applied token after token. What does
  not depend on the state (projections, the conv over the T tokens and
  the tail, dt, the decay) is computed for all T at once; only the state
  update and its read-out loop over the tokens. ``ssm_decode_step`` is
  its T=1 case; the engine's chunked prefill and speculative verify call
  it with T>1, the verify asking for the state after every token.

``conv`` and ``ssd`` are the kernels' wrappers (``transformer.KernelOps``
chooses them); their plain versions are passed only to check the
kernels' run on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.conv1d.ref import tail_snapshots
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
from repro_torch.distributed import kernels as dk
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import apply_norm, norm_specs


def ssm_shapes(cfg: ModelConfig):
    """{leaf: (shape, init, scale)} of one block, the reference's
    ``ssm_params`` layout and init law."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.num_heads(d)
    GN = s.ngroups * s.state_dim
    conv_dim = di + 2 * GN
    return {
        "w_in_x": ((d, di), "normal", None),
        "w_in_z": ((d, di), "normal", None),
        "w_in_B": ((d, GN), "normal", None),
        "w_in_C": ((d, GN), "normal", None),
        "w_in_dt": ((d, H), "normal", None),
        "dt_bias": ((H,), "zeros", None),
        "A_log": ((H,), "uniform", 1.0),
        "D": ((H,), "ones", None),
        "conv_w": ((s.conv_width, conv_dim), "normal", None),
        "conv_b": ((conv_dim,), "zeros", None),
        "out_norm": {"scale": ((di,), "ones", None)},
        "w_out": ((di, d), "normal", None),
    }


def param_specs(cfg: ModelConfig):
    """Logical axes of each leaf, the reference's ``ssm_params`` axes."""
    del cfg
    return {"w_in_x": ("embed", "inner"), "w_in_z": ("embed", "inner"),
            "w_in_B": ("embed", "state"), "w_in_C": ("embed", "state"),
            "w_in_dt": ("embed", "heads"), "dt_bias": ("heads",),
            "A_log": ("heads",), "D": ("heads",), "conv_w": ("conv", "inner"),
            "conv_b": ("inner",), "out_norm": norm_specs("rmsnorm"),
            "w_out": ("inner", "embed")}


class SSMState(NamedTuple):
    h: torch.Tensor          # (B, H, P, N) recurrent state, float32
    conv: torch.Tensor       # (B, conv_width-1, conv_dim) conv tail, float32


def ssm_state_axes() -> SSMState:
    """Logical axes of each leaf of the state."""
    return SSMState(h=("batch", "heads", None, "state"),
                    conv=("batch", None, "inner"))


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cpu") -> SSMState:
    s = cfg.ssm
    d = cfg.d_model
    H, P, N = s.num_heads(d), s.head_dim, s.state_dim
    conv_dim = s.d_inner(d) + 2 * s.ngroups * N
    return SSMState(
        h=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        conv=torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
    )


# ---------------------------------------------------------------------------
# Projections + causal conv shared by both paths
# ---------------------------------------------------------------------------
def _project(params, cfg: ModelConfig, x: torch.Tensor):
    """x (B,S,d) -> z, xBC (pre-conv), dt."""
    # on a mesh a projection's gradient that DTensor would leave with token
    # dims that do not fold cleanly takes its own placements
    # (``sharding.pin_grad``)
    z, xb, Bp, Cp, dt = (shd.pin_grad(x @ params[k].to(x.dtype)) for k in (
        "w_in_z", "w_in_x", "w_in_B", "w_in_C", "w_in_dt"))
    return z, torch.cat([xb, Bp, Cp], dim=-1), dt


def _causal_conv(params, cfg: ModelConfig, xBC: torch.Tensor,
                 tail: Optional[torch.Tensor] = None, *,
                 conv=causal_conv1d):
    """Depthwise causal conv width K with SiLU, through the conv1d
    kernel's wrapper. xBC (B,S,C); tail (B,K-1,C) or None (zeros).
    Returns (silu(conv), new tail in xBC's dtype)."""
    w = params["conv_w"].to(xBC.dtype)                          # (K, C)
    b = params["conv_b"].to(xBC.dtype)
    if tail is not None:
        tail = tail.to(xBC.dtype).contiguous()
    if shd.is_distributed(xBC):
        return dk.conv1d(conv, xBC, w, b, activation="silu", tail=tail)
    return conv(xBC.contiguous(), w.contiguous(), b.contiguous(),
                activation="silu", tail=tail)


def _split_xbc(cfg: ModelConfig, xBC: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    GN = s.ngroups * s.state_dim
    return xBC[..., :di], xBC[..., di:di + GN], xBC[..., di + GN:]


# ---------------------------------------------------------------------------
# SSD chunked dual form (prefill)
# ---------------------------------------------------------------------------
def ssd_chunked(xh, dt, A, Bm, Cm, D, chunk: int, *, ssd=ssd_chunk_fused):
    """SSD dual form. xh (B,S,H,P); dt (B,S,H) post-softplus; A (H,) < 0
    float32; Bm/Cm (B,S,G,N); D (H,). Returns y (B,S,H,P) and the final
    state (B,H,P,N) in xh's dtype.

    Steps 1-2 (the intra-chunk outputs and each chunk's state) go through
    ``ssd``, the SSD-chunk kernel's wrapper, which returns the states in
    float32; they are cast to xh's dtype before the inter-chunk scan, as
    the reference computes them in that dtype, so steps 3-4 are the
    reference's."""
    Bsz, S0, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S0)
    # pad S to a chunk multiple; padded steps have dt=0 -> decay 1, no
    # input, so they change neither the state nor the (discarded) outputs
    pad = (-S0) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S = S0 + pad
    nc = S // Q
    rep = H // G

    # expand groups to heads
    Bc = torch.repeat_interleave(Bm, rep, dim=2).reshape(Bsz, nc, Q, H, N)
    Cc = torch.repeat_interleave(Cm, rep, dim=2).reshape(Bsz, nc, Q, H, N)
    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)

    dA = (dtc * A).float().permute(0, 1, 3, 2)                  # (B,nc,H,Q) log decay
    dA_cs = torch.cumsum(dA, dim=-1).contiguous()               # within-chunk cumsum
    xdt = xc * dtc[..., None]                                   # dt-weighted input

    # 1-2. intra-chunk outputs and per-chunk states, in the kernel
    y_diag, states = ssd(Cc.contiguous(), Bc.contiguous(),
                         xdt.contiguous(), dA_cs)
    states = states.to(xh.dtype)

    # 3. inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cs[..., -1]).to(xh.dtype)        # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                        # state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                         # (B,nc,H,P,N)

    # 4. state -> output contribution within each chunk
    decay_in = torch.exp(dA_cs).to(xh.dtype)                    # (B,nc,H,Q)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cc, h_prev, decay_in)

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    y = y + xh * D.to(xh.dtype)[None, None, :, None]
    return y[:, :S0], h


def _decay_rate(params) -> torch.Tensor:
    """A = -exp(A_log), float32 (H,)."""
    return -torch.exp(params["A_log"].float())


def ssm_block(params, cfg: ModelConfig, x: torch.Tensor, *,
              conv=causal_conv1d, ssd=ssd_chunk_fused):
    """Whole-prompt Mamba-2 block, collecting its state (the reference's
    ``return_state=True``). x (B,S,d) -> (out (B,S,d), SSMState float32)."""
    s = cfg.ssm
    z, xBC, dt = _project(params, cfg, x)
    xBC, tail = _causal_conv(params, cfg, xBC, conv=conv)
    xh, Bm, Cm = _split_xbc(cfg, xBC)
    Bsz, S = x.shape[0], x.shape[1]
    H, P = s.num_heads(cfg.d_model), s.head_dim
    xh = xh.reshape(Bsz, S, H, P)
    xh = constrain(xh, ("batch", "seq", "heads", None))
    Bm = Bm.reshape(Bsz, S, s.ngroups, s.state_dim)
    Cm = Cm.reshape(Bsz, S, s.ngroups, s.state_dim)
    dt = F.softplus(dt + params["dt_bias"].to(dt.dtype))
    args = (xh, dt, _decay_rate(params), Bm, Cm, params["D"])
    if shd.is_distributed(xh):
        # the chunked scan is per head: on local blocks of batch and heads
        y, hT = dk.ssd_chunked(functools.partial(
            ssd_chunked, chunk=s.chunk_size, ssd=ssd), *args)
    else:
        y, hT = ssd_chunked(*args, s.chunk_size, ssd=ssd)
    y = y.reshape(Bsz, S, -1)
    y = apply_norm(params["out_norm"], "rmsnorm", y * F.silu(z))
    out = constrain(y @ params["w_out"].to(x.dtype), ("batch", "seq", "embed"))
    return out, SSMState(h=hT.float(), conv=tail.float())


# ---------------------------------------------------------------------------
# Recurrent form (decode, chunked prefill, speculative verify)
# ---------------------------------------------------------------------------
def ssm_steps(params, cfg: ModelConfig, x: torch.Tensor, state: SSMState, *,
              snapshots: bool = False, conv=causal_conv1d):
    """The reference's one-token ``ssm_decode_step`` applied to each of
    the T tokens of x (B,T,d) in turn, from ``state``. Returns (out
    (B,T,d), the state after the last token), or with ``snapshots`` the
    state after EVERY token, stacked on a leading T axis."""
    s = cfg.ssm
    Bsz, T = x.shape[0], x.shape[1]
    H, P, N, G = (s.num_heads(cfg.d_model), s.head_dim, s.state_dim,
                  s.ngroups)
    K = s.conv_width
    z, xBC_raw, dt = _project(params, cfg, x)                   # (B,T,...)
    xBC, tail = _causal_conv(params, cfg, xBC_raw, tail=state.conv, conv=conv)
    xh, Bm, Cm = _split_xbc(cfg, xBC)
    # as the prefill pins them: on a mesh whose model axis does not divide
    # the heads, the view of a split channel axis as heads is gathered
    xh = constrain(xh.reshape(Bsz, T, H, P), ("batch", "seq", "heads", None))
    rep = H // G
    Bh = torch.repeat_interleave(Bm.reshape(Bsz, T, G, N), rep, dim=2)
    Ch = torch.repeat_interleave(Cm.reshape(Bsz, T, G, N), rep, dim=2)
    dt1 = F.softplus(dt + params["dt_bias"].to(dt.dtype))        # (B,T,H)
    dA = torch.exp(dt1.float() * _decay_rate(params))           # (B,T,H)
    xdt = (xh * dt1[..., None]).float()                         # (B,T,H,P)
    Bh, Ch = Bh.float(), Ch.float()
    args = (state.h, dA, xdt, Bh, Ch)
    if shd.is_distributed(state.h):
        # per slot and head: on local blocks of batch and heads
        y, h, hs = dk.ssm_recurrence(
            functools.partial(_recurrence, snapshots=snapshots), *args)
    else:
        y, h, hs = _recurrence(*args, snapshots=snapshots)
    y = constrain(y + xh.float() * params["D"].float()[:, None],
                  ("batch", "seq", "heads", None))
    y = y.reshape(Bsz, T, H * P).to(x.dtype)
    y = apply_norm(params["out_norm"], "rmsnorm", y * F.silu(z))
    out = y @ params["w_out"].to(x.dtype)
    if snapshots:
        tails = tail_snapshots(xBC_raw, state.conv, K).float()
        return out, SSMState(h=hs, conv=tails)
    return out, SSMState(h=h, conv=tail.float())


def _recurrence(h, dA, xdt, Bh, Ch, *, snapshots: bool = False):
    """The state update and its read-out, token after token: h (B,H,P,N)
    float32, dA (B,T,H), xdt (B,T,H,P), Bh/Ch (B,T,H,N) -> (y (B,T,H,P),
    the last state, the state after every token stacked on a leading T
    axis (``snapshots``) or the last state again)."""
    hs, ys = [], []
    for t in range(dA.shape[1]):
        h = h * dA[:, t, :, None, None] \
            + xdt[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
        if snapshots:
            hs.append(h)
    return torch.stack(ys, dim=1), h, torch.stack(hs) if snapshots else h


def ssm_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                    state: SSMState, *, conv=causal_conv1d):
    """One-token recurrent step. x (B,1,d) -> (out (B,1,d), new state)."""
    return ssm_steps(params, cfg, x, state, conv=conv)
