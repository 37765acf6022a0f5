"""Dom-ST: the full domain-aware distributed spatiotemporal network (Fig. 1)
and the paper's baselines.

Variants (paper Fig. 3 / Table 1):
  * Singlehead          — 1 CNN head, raster partition, no Pix-Con, no (+P)
  * Singlehead(+P)      — + target-day precipitation into the final layers
  * Distributed-Multihead(+P) == Dom-ST — Pix-Con + dynamic partitioning +
    head-parallel spatial block + (+P)

Parameters are one flat dict keyed by the reference's key paths
(``temporal/lstm0/wx``), every leaf with a leading replica (watershed)
axis R; inputs are (R, B, ...). This is the reference's per-watershed
``jax.vmap`` written out; ``forward_single`` runs unstacked params as R=1.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_port_layout
from repro_torch.core.partitioner import partition_pixels, static_partition
from repro_torch.core.pixcon import pixcon_block, pixcon_params
from repro_torch.core.spatial import spatial_block, spatial_params
from repro_torch.core.temporal import temporal_block, temporal_params
from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.pixcon.ops import pixcon_gate
from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
from repro_torch.metrics.nse import nse

Params = Dict[str, torch.Tensor]


class KernelOps(NamedTuple):
    """The two kernels the forward calls."""
    pixcon_gate: Callable
    lstm_cell: Callable


# The forward's kernels: the Hopper kernels on CUDA tensors (through their
# autograd Functions where a gradient is wanted), their plain versions on
# CPU tensors.
KERNELS = KernelOps(pixcon_gate, lstm_cell_fused)
# The plain versions on any device: only for holding the kernels' run
# against them on the card.
PLAIN = KernelOps(pixcon_gate_ref, lstm_cell_ref)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Unstacked leaf shape and init per key path, in the reference's layout."""
    dc = cfg.domst
    groups = {"spatial": spatial_params(dc),
              "temporal": temporal_params(
                  dc, dc.num_heads * dc.cnn_channels)}
    if dc.use_pixcon:
        groups = {"pixcon": pixcon_params(dc.pixcon), **groups}
    return {f"{g}/{k}": v for g, leaves in groups.items()
            for k, v in leaves.items()}


def init(cfg: ModelConfig, generator: torch.Generator, num_watersheds: int,
         device: str | torch.device = "cpu") -> Params:
    """Random stacked params for ``num_watersheds`` replicas, drawn on the
    CPU from ``generator``: normal with std 1/sqrt(fan-in) (the unstacked
    leaf's second-to-last axis, or its only axis) and zero biases, as the
    reference's ``ParamFactory``. The bits differ from the reference's."""
    out = {}
    for key, (shape, kind) in param_shapes(cfg).items():
        full = (num_watersheds, *shape)
        if kind == "zeros":
            t = torch.zeros(full)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t = torch.randn(full, generator=generator) / max(fan_in, 1) ** 0.5
        out[key] = torch.as_tensor(to_port_layout(key, t.numpy())).to(device)
    return out


def subtree(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix/``, keyed relative to it."""
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ops: KernelOps = KERNELS) -> torch.Tensor:
    """batch: precip (R,B,T,P), dist (R,B,P), target_day (R,B,P) -> qhat (R,B).
    ``ops=PLAIN`` (here and in ``loss_fn``/``evaluate``) serves only to
    hold the kernels' run against their plain versions on the card."""
    dc = cfg.domst
    precip = batch["precip"]
    if dc.use_pixcon:
        x, w = pixcon_block(subtree(params, "pixcon"), dc.pixcon, precip,
                            batch["dist"], batch["target_day"],
                            gate=ops.pixcon_gate)
        parts, _ = partition_pixels(x, w, dc.num_heads)
    else:
        parts = static_partition(precip, dc.num_heads)
    feats = spatial_block(subtree(params, "spatial"), dc, parts)
    return temporal_block(subtree(params, "temporal"), dc, feats,
                          batch["target_day"] if dc.use_target_day else None,
                          cell=ops.lstm_cell)


def forward_single(params: Params, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Unstacked params and (B, ...) inputs -> qhat (B,)."""
    return forward({k: v[None] for k, v in params.items()}, cfg,
                   {k: v[None] for k, v in batch.items()})[0]


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ops: KernelOps = KERNELS) -> Tuple[torch.Tensor, Dict]:
    """Per-replica MSE loss (R,) and metrics. Replicas share nothing, so
    the gradient of ``loss.sum()`` gives each replica the gradient of its
    own loss, as the reference's ``jax.vmap`` of the step does. On the card
    the gradient runs through the kernels' autograd Functions (forward on
    the kernel, backward through the plain version)."""
    err = forward(params, cfg, batch, ops) - batch["discharge"]
    loss = torch.mean(torch.square(err), dim=-1)
    return loss, {"mse": loss, "mae": torch.mean(torch.abs(err), dim=-1)}


def evaluate(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             ops: KernelOps = KERNELS) -> Dict[str, torch.Tensor]:
    """Per-replica nse (R,), mse (R,) and the prediction qhat (R,B)."""
    qhat = forward(params, cfg, batch, ops)
    obs = batch["discharge"]
    return {"nse": nse(qhat, obs),
            "mse": torch.mean(torch.square(qhat - obs), dim=-1),
            "qhat": qhat}


def eval_metrics(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor],
                 ops: KernelOps = KERNELS) -> Dict[str, torch.Tensor]:
    """``evaluate`` minus the per-sample qhat series."""
    ev = evaluate(params, cfg, batch, ops)
    return {"nse": ev["nse"], "mse": ev["mse"]}
