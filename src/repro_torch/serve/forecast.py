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
call.

On one device by default; with ``mesh=`` (``launch/mesh.py``) the params
and the forcing windows are placed as in training (the watershed axis on
the batch axes, the heads and hidden units on "model", by the
reference's rules), the forward runs under ``logical_sharding`` with the
Pix-Con and LSTM kernels on local blocks (``local_map``), and the
results are gathered: every rank returns the full (W, N) and (W,)
tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import domst
from repro_torch.device import as_f32, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.metrics.nse import nse

FORCING_KEYS = ("precip", "target_day", "dist")
# day-major placed inputs (N, W, ...) and the observed discharge (W, N)
PLACED_AXES = {"precip": (None, "batch", "time", "pixels"),
               "target_day": (None, "batch", "pixels"),
               "dist": (None, "batch", "pixels"),
               "discharge": ("batch", None)}


class Forecaster:
    """Multi-watershed discharge forecaster on one device.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run on the CPU (kernels then use their plain
    versions). ``ops`` picks the forward's kernels (``domst.PLAIN`` serves
    only to check the kernels against their plain versions).
    """

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 ops: domst.KernelOps = domst.KERNELS, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if mesh.device_type == "cuda" else mesh.device_type)
            self.rules = shd.make_rules(cfg, mesh=mesh)
        self.device = resolve_device(device)
        self.ops = ops

    def place_params(self, params: domst.Params) -> domst.Params:
        """Stacked params as contiguous float32 tensors on the device, or
        DTensors placed by the rules on the mesh."""
        if self.mesh is not None:
            return shd.distribute_tree(
                {k: torch.as_tensor(v) for k, v in params.items()},
                domst.stacked_param_specs(self.cfg), self.mesh, self.rules,
                device=self.device)
        return {k: as_f32(v, self.device) for k, v in params.items()}

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """(W, N, ...) arrays -> day-major (N, W, ...) tensors on the device,
        so each day's (W, ...) slice is contiguous; ``discharge`` stays
        (W, N). On the mesh each is a DTensor, the watershed axis on the
        batch axes."""
        if self.mesh is None:
            out = {k: as_f32(batch[k], self.device).transpose(0, 1)
                   .contiguous() for k in FORCING_KEYS}
            out["discharge"] = as_f32(batch["discharge"], self.device)
            return out
        out = {k: torch.as_tensor(batch[k]).float().transpose(0, 1)
               .contiguous() for k in FORCING_KEYS}
        out["discharge"] = torch.as_tensor(batch["discharge"]).float()
        return {k: shd.distribute(v, self.mesh, shd.resolve(
            PLACED_AXES[k], v.shape, self.mesh, self.rules), self.device)
            for k, v in out.items()}

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
        # DTensor views refuse inference tensors: no_grad on a mesh
        no_grad = torch.inference_mode if self.mesh is None else torch.no_grad
        with no_grad(), shd.mesh_context(self.mesh,
                                         getattr(self, "rules", None)):
            for n in range(obs.shape[1]):
                day = {k: placed[k][n].unsqueeze(1) for k in FORCING_KEYS}
                qs.append(domst.forward(params, self.cfg, day, self.ops)[:, 0])
            qhat = torch.stack(qs, dim=1)                         # (W, N)
            out = {"qhat": qhat, "nse": nse(qhat, obs),
                   "mse": torch.mean(torch.square(qhat - obs), dim=-1)}
            if self.mesh is not None:
                out = {k: v.full_tensor() for k, v in out.items()}
            return out
