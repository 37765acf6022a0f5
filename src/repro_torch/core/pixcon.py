"""Pix-Con — the paper's pixel-contribution block (Fig. 1a).

Computes pixel-specific weights from the domain prior (distance of each
pixel to the nearest water source) together with the pixel's precipitation
statistics over the input window, and transforms the spatiotemporal input
by its local contribution to the outlet discharge:

    feats_p = [dist_p, mean_t precip[t,p], max_t precip[t,p], target_day_p]
    score_p = MLP(feats_p)                       (per pixel)
    w_p     = sigmoid(score_p / temperature)
    x'[t,p] = x[t,p] * w_p            (optionally sum-normalized over p)

Every tensor carries a leading replica (watershed) axis R. The gate runs in
the Hopper kernel ``kernels/pixcon`` on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import PixConConfig
from repro_torch.kernels.pixcon.ops import pixcon_gate
from repro_torch.kernels.pixcon.ref import pixcon_gate_ref

NUM_FEATS = 4  # dist, mean, max, target-day


def pixcon_params(pc: PixConConfig):
    """Unstacked leaf shapes and inits, in the reference's layout."""
    return {
        "w1": ((NUM_FEATS, pc.hidden), "normal"),
        "b1": ((pc.hidden,), "zeros"),
        "w2": ((pc.hidden, 1), "normal"),
        "b2": ((1,), "zeros"),
    }


def pixel_features(precip: torch.Tensor, dist: torch.Tensor,
                   target_day: torch.Tensor) -> torch.Tensor:
    """precip (R,B,T,P), dist (R,B,P), target_day (R,B,P) -> (R,B,P,F)."""
    mean_p = precip.mean(dim=-2)
    max_p = precip.amax(dim=-2)
    return torch.stack([dist, mean_p, max_p, target_day], dim=-1)


def contribution_weights(params: Dict[str, torch.Tensor], pc: PixConConfig,
                         precip: torch.Tensor, dist: torch.Tensor,
                         target_day: torch.Tensor) -> torch.Tensor:
    """-> w (R,B,P), the plain version of the weights the kernel writes."""
    f = pixel_features(precip, dist, target_day)
    _, w = pixcon_gate_ref(precip, f, params["w1"], params["b1"],
                           params["w2"], params["b2"],
                           temperature=pc.temperature, normalize=pc.normalize)
    return w


def pixcon_block(params: Dict[str, torch.Tensor], pc: PixConConfig,
                 precip: torch.Tensor, dist: torch.Tensor,
                 target_day: torch.Tensor, *, gate: Callable = pixcon_gate
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (transformed precip (R,B,T,P), weights (R,B,P))."""
    f = pixel_features(precip, dist, target_day)
    return gate(precip, f, params["w1"], params["b1"], params["w2"],
                params["b2"], temperature=pc.temperature,
                normalize=pc.normalize)
