"""Plain PyTorch reference of Dom-ST (Sarkar, Lu, Jannesari 2023, Fig. 1:
Distributed-Multihead(+P)) trained in IP-D: one replica per watershed,
each with its own loss, clip and AdamW step.

The parameters are the port's flat dict of stacked leaves (R, ...):

  * Pix-Con: ``pixcon/w1`` (R,4,Hp), ``b1`` (R,Hp), ``w2`` (R,Hp),
    ``b2`` (R,1). Each pixel's features (distance prior, the window's
    mean and maximum precipitation, the target day's) go through a tanh
    MLP to a score; ``w = sigmoid(score / temperature)``, scaled to sum
    to P over the pixels; the window is weighted by ``w``.
  * the partition: pixels ranked by ``w`` (highest first, stable), cut
    into G groups of P/G, group g feeding head g.
  * the spatial block: per head two SAME temporal convs (kernel K, ReLU):
    ``spatial/conv_w`` (R,G,K,P/G,C), ``conv_b`` (R,G,C), ``conv2_w``
    (R,G,K,C,C), ``conv2_b`` (R,G,C); the heads' features concatenated
    head-major into (R,B,T,G*C).
  * the LSTM stack: ``temporal/lstm<l>/wx`` (R,D,4,H), ``wh`` (R,H,4,H),
    ``b`` (R,4,H), gates i|f|g|o, forget bias +1.
  * the (+P) head: the last hidden state and the target day's pixels,
    ``tanh(. @ fc1 + fc1_b) @ fc2 + fc2_b``; MSE against the discharge.

The weighted sums of the Pix-Con MLP and of its normalisation are written
out in index order, as the port's CUDA kernel sums them: the partition
ranks pixels by ``w``, and a weight that differed from the kernel's in
its last bit could swap two neighbours of the ranking. Everything else is
this file's own formulation. The pixel features (a function of the
inputs alone) are computed once over every replica, as the program does,
so that their float32 sums over the days run in the same order.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from bench.reference.adamw import AdamW, replica_norms
from bench.reference.precision import Precision

Tree = Dict[str, torch.Tensor]
FAULTS = ("half_batch", "altered_answer")


def pixel_features(precip, dist, target_day) -> torch.Tensor:
    """precip (R,B,T,P), dist and target_day (R,B,P) -> (R,B,P,4)."""
    return torch.stack([dist, precip.mean(dim=-2), precip.amax(dim=-2),
                        target_day], dim=-1)


def _gate(x, feats, w1, b1, w2, b2, temperature: float, normalize: bool):
    """The contribution weights w (R,B,P) and the weighted window."""
    w1 = w1[:, None, None]                                      # (R,1,1,F,Hp)
    a = feats[..., 0, None] * w1[..., 0, :]
    for f in range(1, feats.shape[-1]):
        a = a + feats[..., f, None] * w1[..., f, :]
    h = torch.tanh(a + b1[:, None, None, :])                    # (R,B,P,Hp)
    w2 = w2[:, None, None, :]
    s = h[..., 0] * w2[..., 0]
    for k in range(1, h.shape[-1]):
        s = s + h[..., k] * w2[..., k]
    w = torch.sigmoid((s + b2[:, None, :]) * (1.0 / temperature))
    if normalize:
        total = w[..., 0:1]
        for p in range(1, w.shape[-1]):
            total = total + w[..., p:p + 1]
        w = w * (w.shape[-1] / torch.clamp_min(total, 1e-6))
    return x * w[..., None, :], w


def _groups(x: torch.Tensor, order: Optional[torch.Tensor],
            G: int) -> torch.Tensor:
    """x (R,B,T,P) with its pixels in ``order`` (raster order if None) cut
    into G heads: (R,B,G,T,P/G)."""
    if order is not None:
        x = torch.gather(x, -1, order[..., None, :].expand(x.shape))
    R, B, T, P = x.shape
    return x.reshape(R, B, T, G, P // G).permute(0, 1, 3, 2, 4)


def _conv_same(x, w, b, ein: Precision):
    """x (R,B,G,T,Ci), w (R,G,K,Ci,Co), b (R,G,Co): a SAME conv along T."""
    K = w.shape[2]
    left = (K - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, left, K - 1 - left))
    win = xp.unfold(3, K, 1)                                    # (R,B,G,T,Ci,K)
    return ein.einsum("rbgtik,rgkio->rbgto", win, w) + b[:, None, :, None]


def _lstm(x, wx, wh, b, ein: Precision):
    """x (R,B,T,D) -> hidden states (R,B,T,H)."""
    R, B, T, _ = x.shape
    H = wh.shape[1]
    w = torch.cat([wx, wh], dim=1)                              # (R,D+H,4,H)
    h = x.new_zeros((R, B, H))
    c = x.new_zeros((R, B, H))
    out = []
    for t in range(T):
        z = ein.einsum("rbk,rkgh->rbgh", torch.cat([x[:, :, t], h], -1), w)
        i, f, g, o = (z + b[:, None]).unbind(-2)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=2)


def forward(p: Tree, dc: Mapping, batch: Tree, feats: torch.Tensor,
            ein: Precision) -> torch.Tensor:
    """The predicted discharge (R,B) of a block of replicas."""
    G = dc["num_heads"]
    x = batch["precip"]
    if dc["use_pixcon"]:
        pc = dc["pixcon"]
        x, w = _gate(x, feats, p["pixcon/w1"], p["pixcon/b1"], p["pixcon/w2"],
                     p["pixcon/b2"], pc["temperature"], pc["normalize"])
        order = torch.argsort(-w.detach(), dim=-1, stable=True)
    else:
        order = None
    h = _groups(x, order, G)
    h = torch.relu(_conv_same(h, p["spatial/conv_w"], p["spatial/conv_b"],
                              ein))
    h = torch.relu(_conv_same(h, p["spatial/conv2_w"], p["spatial/conv2_b"],
                              ein))
    R, B, _, T, C = h.shape
    h = h.permute(0, 1, 3, 2, 4).reshape(R, B, T, G * C)
    for l in range(dc["lstm_layers"]):
        h = _lstm(h, p[f"temporal/lstm{l}/wx"], p[f"temporal/lstm{l}/wh"],
                  p[f"temporal/lstm{l}/b"], ein)
    last = h[:, :, -1]
    if dc["use_target_day"]:
        last = torch.cat([last, batch["target_day"]], dim=-1)
    z = torch.tanh(ein.matmul(last, p["temporal/fc1"])
                   + p["temporal/fc1_b"][:, None])
    return (ein.matmul(z, p["temporal/fc2"])
            + p["temporal/fc2_b"][:, None])[..., 0]


def losses(p: Tree, dc: Mapping, batch: Tree, feats: torch.Tensor,
           ein: Precision, fault: Optional[str] = None) -> torch.Tensor:
    """Each replica's MSE (R,). ``fault`` plants a fault of the timed path
    in its place: ``half_batch`` takes the mean over the first half of the
    windows only; ``altered_answer`` adds 1 to the prediction of each
    replica's first window."""
    q = forward(p, dc, batch, feats, ein)
    target = batch["discharge"]
    if fault == "altered_answer":
        q = torch.cat([q[:, :1] + 1.0, q[:, 1:]], dim=1)
    elif fault == "half_batch":
        half = q.shape[1] // 2
        q, target = q[:, :half], target[:, :half]
    elif fault is not None:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    return torch.mean(torch.square(q - target), dim=-1)


def train(params0: Tree, batches: List[Tree], dc: Mapping, tc: Mapping, *,
          precision: str = "fp32", fault: Optional[str] = None,
          block: int = 64) -> Dict:
    """``len(batches)`` IP-D steps from ``params0`` (stacked leaves on the
    device; not modified), a block of ``block`` replicas at a time.
    Returns the readings the check compares: each step's loss (steps, R),
    each leaf's norm of the first step's clipped gradient (R,), and each
    leaf's norm of the change of the params over the steps (R,)."""
    ein = Precision(precision)
    feats = [pixel_features(b["precip"], b["dist"], b["target_day"])
             for b in batches]
    R = next(iter(params0.values())).shape[0]
    out = {"loss": [], "grad": [], "change": []}
    for r0 in range(0, R, block):
        sl = slice(r0, min(R, r0 + block))
        p = {k: v[sl].clone().requires_grad_() for k, v in params0.items()}
        opt = AdamW(p, tc)
        loss_rows = []
        for i, b in enumerate(batches):
            loss = losses(p, dc, {k: v[sl] for k, v in b.items()},
                          feats[i][sl], ein, fault)
            grads = torch.autograd.grad(loss.sum(), list(p.values()))
            g = opt.clipped(dict(zip(p, grads)))
            if i == 0:
                out["grad"].append(replica_norms(g))
            opt.step(p, g)
            loss_rows.append(loss.detach())
        out["loss"].append(torch.stack(loss_rows))
        out["change"].append(replica_norms(
            {k: p[k].detach() - params0[k][sl] for k in p}))
    return {"loss": torch.cat(out["loss"], dim=1).double().cpu().numpy(),
            "grad": _join(out["grad"]), "change": _join(out["change"])}


def _join(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    return {k: torch.cat([p[k] for p in parts]).double().cpu().numpy()
            for k in parts[0]}
