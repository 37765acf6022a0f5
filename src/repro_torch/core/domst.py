"""Dom-ST: the full domain-aware distributed spatiotemporal network (Fig. 1)
and the paper's baselines.

On a mesh (DTensor params and batch, see ``train/engine.py``) the
Pix-Con gate with the pixel ranking and each LSTM layer's steps run on
local blocks through ``local_map`` (``sharding.local_rows``), their small
weights gathered over "model"; the spatial block's per-head convs run on
local blocks too, the heads on "model" (``constrain``).

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
from repro_torch.distributed import sharding as shd
from repro_torch.core.partitioner import partition_pixels, static_partition
from repro_torch.core.pixcon import param_specs as pixcon_specs
from repro_torch.core.pixcon import pixcon_block, pixcon_params
from repro_torch.core.spatial import param_specs as spatial_specs
from repro_torch.core.spatial import spatial_block, spatial_params
from repro_torch.core.temporal import param_specs as temporal_specs
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


# Logical axes of each batch input without the replica axis; the engine
# and the forecaster put it in front (see ``batch_specs``).
BATCH_AXES = {
    "precip": ("batch", "time", "pixels"),
    "target_day": ("batch", "pixels"),
    "dist": ("batch", "pixels"),
    "discharge": ("batch",),
}


def param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of each unstacked leaf, keyed as ``param_shapes``: the
    reference's ``param_specs`` in the port's layout."""
    dc = cfg.domst
    groups = {"spatial": spatial_specs(), "temporal": temporal_specs(dc)}
    if dc.use_pixcon:
        groups = {"pixcon": pixcon_specs(), **groups}
    return {f"{g}/{k}": v for g, leaves in groups.items()
            for k, v in leaves.items()}


def stacked_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """The leaves' axes with the leading watershed axis, ``"batch"``: the
    rules put it on ("pod", "data"), one watershed's model to a rank."""
    return {k: ("batch",) + v for k, v in param_specs(cfg).items()}


def batch_specs(stacked: bool) -> Dict[str, tuple]:
    """Axes of each placed batch input, replica axis in front: stacked,
    the watershed axis takes ``"batch"`` and the per-watershed minibatch
    axis stays whole (a watershed's samples stay on its rank); single
    mode, the replica axis has size 1 and the minibatch takes it."""
    if stacked:
        return {k: ("batch",) + tuple(None if a == "batch" else a for a in v)
                for k, v in BATCH_AXES.items()}
    return {k: (None,) + v for k, v in BATCH_AXES.items()}


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
        pp = subtree(params, "pixcon")
        names = sorted(pp)

        def gate_parts(x, dist, td, *w):
            x, wts = pixcon_block(dict(zip(names, w)), dc.pixcon, x, dist,
                                  td, gate=ops.pixcon_gate)
            return partition_pixels(x, wts, dc.num_heads)[0]
        args = [precip, batch["dist"], batch["target_day"]]
        if shd.is_distributed(precip):
            # on a mesh the gate and the ranking run on local blocks
            parts = shd.local_rows(gate_parts, args, [pp[k] for k in names])
        else:
            parts = gate_parts(*args, *(pp[k] for k in names))
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


# ---------------------------------------------------------------------------
# Train steps: thin veneers over the engine (``train/engine.py``), with
# donation off because callers of this seed-era signature own the params
# and optimizer state and may reuse them across calls.
# ---------------------------------------------------------------------------
def _seed_step(engine):
    def train_step(params, opt_state, batch):
        st, m = engine.step(engine.wrap(params, opt_state),
                            engine.place_batch(batch))
        return st.params, st.opt_state, m
    return train_step


def make_train_step(cfg: ModelConfig, tc, *, mesh=None,
                    device: str | torch.device = "cuda"):
    """Single-watershed step ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``: params with the replica axis R=1
    (``init(cfg, g, 1)``), ``opt_state`` from ``make_optimizer(tc)[0]``,
    a host or device batch of (B, ...) inputs; scalar metrics. The
    caller's tensors are left as they were."""
    from repro_torch.train import Engine
    return _seed_step(Engine.for_domst(cfg, tc, donate=False, device=device,
                                       mesh=mesh))


def make_stacked_train_step(cfg: ModelConfig, tc, *, mesh=None,
                            device: str | torch.device = "cuda"):
    """Vectorised multi-watershed step: params and batches with a leading
    watershed axis (W, ...), one replica per watershed (paper Fig. 2a);
    per-watershed metrics (W,). ``mesh`` puts that axis on its data
    axes."""
    from repro_torch.train import Engine
    return _seed_step(Engine.for_domst(cfg, tc, stacked=True, donate=False,
                                       device=device, mesh=mesh))
