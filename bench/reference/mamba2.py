"""Plain PyTorch reference of a Mamba-2 language model (Dao and Gu 2024,
arXiv:2405.21060) and its training step, in float32.

The parameters are a flat dict keyed by '/'-joined paths, as the port
keeps them: ``embed/embedding`` (V', d) (V' the vocabulary padded to a
multiple of 128; its padding columns never win), ``final_norm/scale``,
and per layer ``layers/<i>/norm1/scale`` and ``layers/<i>/ssm/``:
``w_in_x``, ``w_in_z`` (d, di), ``w_in_B``, ``w_in_C`` (d, G*N),
``w_in_dt`` (d, H), ``dt_bias``, ``A_log``, ``D`` (H,), ``conv_w`` (K,
di+2GN), ``conv_b``, ``out_norm/scale`` (di,), ``w_out`` (di, d).

A layer is ``x + mixer(rmsnorm(x))``; the mixer projects z, x, B, C and
dt, runs the depthwise causal conv (width K, SiLU) over x|B|C, the SSD
scan with ``A = -exp(A_log)``, ``dt = softplus(dt + dt_bias)`` and the
skip ``D``, gates by ``silu(z)`` under an RMSNorm, and projects out. The
SSD scan is the paper's chunked "minimal" form (its Listing 1): the
quadratic form inside a chunk and the chunk states' recurrence as a
segment-sum matrix, at this file's own chunk length. The head is tied to
the embedding; the loss is the mean token cross-entropy.

The forward runs a few sequences at a time, every layer checkpointed, so
that a step at the timed batch fits beside nothing else on the card.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.adamw import AdamW, replica_norms
from bench.reference.precision import Precision

Tree = Dict[str, torch.Tensor]
FAULTS = ("half_batch", "altered_answer")
CHUNK = 128          # the scan's chunk here; the result does not depend on it


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): entry [i, j] is x[j+1] + ... + x[i] for
    i >= j, and -inf above the diagonal."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    xx = xx.masked_fill(~below, 0.0)
    out = torch.cumsum(xx, dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(0)
    return out.masked_fill(~keep, float("-inf"))


def ssd(X, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """The SSD scan from a zero state. X (b,S,H,P), dt (b,S,H) after the
    softplus, A (H,) < 0, Bm/Cm (b,S,G,N) -> y (b,S,H,P) (without D)."""
    b, S0, H, P = X.shape
    G = Bm.shape[2]
    Bm = Bm.repeat_interleave(H // G, dim=2)
    Cm = Cm.repeat_interleave(H // G, dim=2)
    pad = (-S0) % chunk
    if pad:                      # dt = 0: the padding leaves the state alone
        X, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (X, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    c = X.shape[1] // chunk
    Xd = (X * dt[..., None]).reshape(b, c, chunk, H, P)
    Bc = Bm.reshape(b, c, chunk, H, -1)
    Cc = Cm.reshape(b, c, chunk, H, -1)
    Ad = (dt * A).reshape(b, c, chunk, H).permute(0, 3, 1, 2)   # (b,H,c,l)
    Acs = torch.cumsum(Ad, dim=-1)
    L = torch.exp(segsum(Ad))                                   # (b,H,c,l,s)
    CB = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB * L, Xd)
    decay = torch.exp(Acs[..., -1:] - Acs).permute(0, 2, 3, 1)  # (b,c,l,H)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc * decay[..., None], Xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(Acs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, states) \
        * torch.exp(Acs).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b, c * chunk, H, P)[:, :S0]


def mixer(p: Tree, pre: str, m: Mapping, x: torch.Tensor,
          ein: Precision) -> torch.Tensor:
    """The Mamba-2 mixer of the layer whose leaves start with ``pre``."""
    s = m["ssm"]
    d = m["d_model"]
    di = s["expand"] * d
    H = di // s["head_dim"]
    GN = s["ngroups"] * s["state_dim"]
    K = s["conv_width"]
    z, xi, Bp, Cp, dt = (ein.act(ein.matmul(x, p[pre + k])) for k in (
        "w_in_z", "w_in_x", "w_in_B", "w_in_C", "w_in_dt"))
    xbc = torch.cat([xi, Bp, Cp], dim=-1)                       # (b,S,C)
    C = xbc.shape[-1]
    conv = F.conv1d(xbc.transpose(1, 2), p[pre + "conv_w"].t()[:, None, :],
                    p[pre + "conv_b"], padding=K - 1, groups=C)
    xbc = ein.act(F.silu(conv[..., :x.shape[1]].transpose(1, 2)))
    b, S = x.shape[:2]
    xh = xbc[..., :di].reshape(b, S, H, s["head_dim"])
    Bm = xbc[..., di:di + GN].reshape(b, S, s["ngroups"], s["state_dim"])
    Cm = xbc[..., di + GN:].reshape(b, S, s["ngroups"], s["state_dim"])
    dt = F.softplus(dt + p[pre + "dt_bias"])
    A = -torch.exp(p[pre + "A_log"])
    y = ein.act(ssd(xh, dt, A, Bm, Cm, CHUNK))
    y = y + xh * p[pre + "D"][:, None]
    y = rmsnorm(y.reshape(b, S, di) * F.silu(z), p[pre + "out_norm/scale"],
                m["norm_eps"])
    return ein.act(ein.matmul(y, p[pre + "w_out"]))


def nll(p: Tree, m: Mapping, tokens: torch.Tensor, targets: torch.Tensor,
        ein: Precision, loss_chunk: int = 512) -> torch.Tensor:
    """The summed token NLL of a few rows (b, S) of tokens and targets."""
    eps = m["norm_eps"]
    x = ein.act(p["embed/embedding"][tokens.long()])
    for i in range(m["num_layers"]):
        pre = f"layers/{i}/"

        def layer(x, pre=pre):
            return ein.act(x + mixer(p, pre + "ssm/", m, rmsnorm(
                x, p[pre + "norm1/scale"], eps), ein))
        x = checkpoint(layer, x, use_reentrant=False)
    x = rmsnorm(x, p["final_norm/scale"], eps)
    V = m["vocab_size"]

    def piece(xc, tc):
        logits = ein.act(ein.matmul(xc, p["embed/embedding"].t()))
        logits = logits.masked_fill(
            torch.arange(logits.shape[-1], device=logits.device) >= V,
            float("-inf"))
        gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()
    total = x.new_zeros(())
    for i in range(0, x.shape[1], loss_chunk):
        total = total + checkpoint(piece, x[:, i:i + loss_chunk],
                                   targets[:, i:i + loss_chunk],
                                   use_reentrant=False)
    return total


def train(params0: Tree, batches: List[Dict[str, torch.Tensor]],
          m: Mapping, tc: Mapping, *, precision: str = "fp32",
          fault: Optional[str] = None, rows: int = 4) -> Dict:
    """``len(batches)`` AdamW steps from ``params0`` (leaves with a leading
    replica axis of 1, on the device; not modified) on token batches
    (``tokens``, ``targets`` (B, S)), ``rows`` sequences at a time.
    ``fault``: ``half_batch`` trains on the first half of the rows,
    ``altered_answer`` on a batch whose first row's targets are shifted
    one token along. Returns each step's loss (steps, 1), each leaf's norm
    of the first step's clipped gradient (1,), and each leaf's norm of the
    change of the params over the steps (1,)."""
    ein = Precision(precision)
    p = {k: v[0].clone().requires_grad_() for k, v in params0.items()}
    opt = AdamW(p, tc)
    losses, grad0 = [], None
    for i, batch in enumerate(batches):
        tokens, targets = batch["tokens"], batch["targets"]
        if fault == "half_batch":
            tokens, targets = (t[:t.shape[0] // 2] for t in (tokens, targets))
        elif fault == "altered_answer":
            targets = torch.cat([targets[:1].roll(1, dims=1), targets[1:]])
        elif fault is not None:
            raise ValueError(f"fault {fault!r} not in {FAULTS}")
        count = targets.numel()
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        loss = 0.0
        for r in range(0, tokens.shape[0], rows):
            part = nll(p, m, tokens[r:r + rows], targets[r:r + rows],
                       ein) / count
            for k, g in zip(p, torch.autograd.grad(part, list(p.values()))):
                grads[k] += g
            loss += float(part.detach())
        g = opt.clipped({k: v[None] for k, v in grads.items()})
        g = {k: v[0] for k, v in g.items()}
        if i == 0:
            grad0 = replica_norms({k: v[None] for k, v in g.items()})
        opt.step(p, g)
        losses.append([loss])
    change = replica_norms({k: (p[k].detach() - params0[k][0])[None]
                            for k in p})
    return {"loss": np.asarray(losses, dtype=np.float64),
            "grad": {k: v.double().cpu().numpy() for k, v in grad0.items()},
            "change": {k: v.double().cpu().numpy()
                       for k, v in change.items()}}
