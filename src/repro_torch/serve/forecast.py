"""Dom-ST serving: day-by-day discharge forecasting from stacked
per-watershed params, on one card.

A :class:`Forecaster` takes stacked multi-watershed params (leading axis =
watershed) and rolls the network forward DAY BY DAY over the forcing
windows: for each day, one ``domst.forward`` over all watersheds at once
(R = W replicas, B = 1), each step consuming that day's trailing
precipitation window + domain prior and emitting that day's discharge.
This is the reference's ``lax.scan`` over days inside a ``vmap`` over
watersheds, written as a loop over days with the watershed axis kept.
Per-watershed NSE/MSE against observed discharge come back from the same
call. There are no meshes and no shardings: it runs on one device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import domst
from repro_torch.device import as_f32, resolve_device
from repro_torch.metrics.nse import nse

FORCING_KEYS = ("precip", "target_day", "dist")


class Forecaster:
    """Multi-watershed discharge forecaster on one device.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run on the CPU (kernels then use their plain
    versions). ``ops`` picks the forward's kernels (``domst.PLAIN`` serves
    only to check the kernels against their plain versions).
    """

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 ops: domst.KernelOps = domst.KERNELS):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ops = ops

    def place_params(self, params: domst.Params) -> domst.Params:
        """Stacked params as contiguous float32 tensors on the device."""
        return {k: as_f32(v, self.device) for k, v in params.items()}

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """(W, N, ...) arrays -> day-major (N, W, ...) tensors on the device,
        so each day's (W, ...) slice is contiguous; ``discharge`` stays
        (W, N)."""
        out = {k: as_f32(batch[k], self.device).transpose(0, 1).contiguous()
               for k in FORCING_KEYS}
        out["discharge"] = as_f32(batch["discharge"], self.device)
        return out

    def __call__(self, params: domst.Params, batch: Dict[str, Any]
                 ) -> Dict[str, torch.Tensor]:
        """params: stacked (W, ...) dict; batch: (W, N, ...) forcing windows
        plus observed ``discharge`` (W, N). Returns per-watershed qhat
        (W, N), nse (W,) and mse (W,)."""
        return self.forecast(self.place_params(params), self.place_batch(batch))

    def forecast(self, params: domst.Params, placed: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """``__call__`` on what ``place_params``/``place_batch`` returned."""
        obs = placed["discharge"]
        qs = []
        with torch.inference_mode():
            for n in range(obs.shape[1]):
                day = {k: placed[k][n].unsqueeze(1) for k in FORCING_KEYS}
                qs.append(domst.forward(params, self.cfg, day, self.ops)[:, 0])
            qhat = torch.stack(qs, dim=1)                         # (W, N)
            return {"qhat": qhat, "nse": nse(qhat, obs),
                    "mse": torch.mean(torch.square(qhat - obs), dim=-1)}
