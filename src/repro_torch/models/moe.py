"""Mixture-of-experts FFN with capacity-based gather/scatter dispatch: the
port of ``repro/models/moe.py`` on one device.

The router runs in float32 and keeps each token's ``top_k`` experts,
their weights renormalised to sum to 1. Each batch row dispatches on its
own: an expert takes at most ``capacity(S)`` of the row's assignments, in
the order of the flattened (S * top_k) assignment stream, token-major,
and drops the rest (the standard capacity-factor scheme). The capacity
follows the call's shape, so a whole prefill, a chunk and a verify step
of the same tokens may drop differently, as the reference's do.

Three things differ in form, not in result, from the reference:

* the top-k is a stable sort, so equal probabilities keep the lower
  expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
  order among ties, and the order decides which assignments are dropped);
* a dropped assignment writes its token id to a sink position of its
  own, where the reference sends them all to one overflow bucket: no two
  writes meet, so the dispatch is deterministic on the card;
* the combine gathers each kept assignment's output at its (expert,
  slot) and sums over k, where the reference scatter-adds the (E, C)
  slots into the tokens (an ``index_add_`` would use atomics on the
  card); an empty slot adds exactly 0 there, so the sum is the same.

No step reads a value back to the host.

On a mesh, ``moe_block_auto`` takes ``moe_block_sharded``, expert
parallelism, whenever the rules put ``experts`` on "model" and E divides
its size (the reference's default): inside ``local_map`` each "model"
rank routes its batch block whole, once, dispatches to its E/ways
experts only and combines their outputs locally into a (B, S, d) part,
with the same dispatch and combine as ``moe_block`` (``_expert_outputs``,
which ``moe_block`` runs on all E experts); one all-reduce over "model"
(the output's Partial placement reduced by ``constrain``) sums the
parts, and the load-balance loss is averaged over the whole mesh: where
"data" splits the batch, that is the mean of the blocks' losses, as in
the reference's expert-parallel path, not the loss of the whole batch
(the loss is a product of two batch means). The capacity is the
reference's, per call and per batch row.
Otherwise ``moe_block`` runs, as DTensor ops: the dispatch's ``cumsum``
and top-k have no sharding rule, so DTensor raises there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.models.mlp import _act, mlp_block, mlp_shapes
from repro_torch.models.mlp import param_specs as mlp_specs


def moe_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """{leaf: (shape, init, scale)} of one MoE FFN, the reference's
    ``moe_params``: the router normal with std 0.02, the stacked expert
    weights by the fan-in rule, and the shared experts' gated MLP."""
    m, d = cfg.moe, cfg.d_model
    p: Dict[str, Any] = {
        "router": ((d, m.num_experts), "normal", 0.02),
        "w_gate": ((m.num_experts, d, m.d_ff_expert), "normal", None),
        "w_up": ((m.num_experts, d, m.d_ff_expert), "normal", None),
        "w_down": ((m.num_experts, m.d_ff_expert, d), "normal", None),
    }
    if m.num_shared:
        p["shared"] = mlp_shapes(d, m.d_ff_shared
                                 or m.d_ff_expert * m.num_shared)
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of each leaf, the reference's ``moe_params`` axes:
    experts on the model axis."""
    p: Dict[str, Any] = {"router": ("embed", "experts"),
                         "w_gate": ("experts", "embed", "ffn"),
                         "w_up": ("experts", "embed", "ffn"),
                         "w_down": ("experts", "ffn", "embed")}
    if cfg.moe.num_shared:
        p["shared"] = mlp_specs()
    return p


def capacity(seq_len: int, m: MoEConfig, factor: float = 1.25) -> int:
    """Per-row expert capacity C = ceil(S * top_k / E * factor)."""
    return max(math.ceil(seq_len * m.top_k / m.num_experts * factor), 1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, largest first,
    the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig):
    """Router in float32. x (B,S,d) -> (probs (B,S,E), topk_idx (B,S,K),
    topk_w (B,S,K))."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = top_k(probs, m.top_k)
    # deepseek-style: renormalize the selected weights
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_idx, topk_w


def load_balance_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
                      m: MoEConfig) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    E = m.num_experts
    one_hot = F.one_hot(topk_idx, E).float()             # (B,S,K,E)
    f = one_hot.sum(2).mean((0, 1))                      # fraction routed
    p = probs.mean((0, 1))
    return E * (f * p).sum() / m.top_k


def dispatch_indices(topk_idx: torch.Tensor, m: MoEConfig, cap: int):
    """The reference's ``_dispatch_indices`` on every batch row at once:
    (B,S,K) assignments -> (idx (B,E,C) token ids, valid (B,E,C), keep
    (B,S,K), slot (B,S,K)). An assignment's slot is its position among
    its expert's assignments in the flattened (S*K) stream; those at or
    past ``cap`` are dropped."""
    B, S, K = topk_idx.shape
    E, dev = m.num_experts, topk_idx.device
    flat_e = topk_idx.reshape(B, S * K)
    one_hot = F.one_hot(flat_e, E)                       # (B, S*K, E)
    pos = one_hot.cumsum(1) - 1                          # position within expert
    slot = pos.gather(2, flat_e[..., None])[..., 0]      # (B, S*K)
    keep = slot < cap
    # token ids into the (E, C) slots; each dropped assignment into a
    # sink position of its own past them, cut off below
    sink = E * cap + torch.arange(S * K, device=dev)
    where = torch.where(keep, flat_e * cap + slot, sink)
    tok = torch.arange(S, device=dev).repeat_interleave(K).expand(B, -1)
    idx = torch.zeros(B, E * cap + S * K, dtype=torch.int64, device=dev)
    idx.scatter_(1, where, tok)
    # an expert's slots fill from 0, so the first min(count, C) are taken
    taken = one_hot.sum(1).clamp(max=cap)                # (B, E)
    valid = torch.arange(cap, device=dev) < taken[..., None]
    return (idx[:, :E * cap].view(B, E, cap), valid, keep.view(B, S, K),
            slot.view(B, S, K))


def _expert_outputs(cfg: ModelConfig, e0: int, x, topk_idx, topk_w,
                    w_gate, w_up, w_down) -> torch.Tensor:
    """The routed FFN of experts e0..e0+El (``w_*`` (El, ...)): x (B,S,d)
    dispatched by its routing (``topk_idx``, ``topk_w`` (B,S,K)) to their
    slots, run, and their kept assignments' weighted outputs summed into
    (B,S,d). All E experts (e0=0) are ``moe_block``'s FFN; one rank's
    share is its part of the expert-parallel sum."""
    m = cfg.moe
    B, S, d = x.shape
    El = w_gate.shape[0]
    cap = capacity(S, m, m.capacity_factor)
    idx, valid, keep, slot = dispatch_indices(topk_idx, m, cap)
    idx, valid = idx[:, e0:e0 + El], valid[:, e0:e0 + El]
    if El < m.num_experts:
        # one rank's share: another rank's assignments count as dropped
        keep = keep & (topk_idx >= e0) & (topk_idx < e0 + El)
        topk_idx = topk_idx - e0

    # gather tokens per expert, then expert-major rows: (El, B*C, d)
    xe = x.gather(1, idx.reshape(B, El * cap, 1).expand(B, El * cap, d))
    xe = xe * valid.reshape(B, El * cap, 1).to(x.dtype)
    xe = xe.view(B, El, cap, d).transpose(0, 1).reshape(El, B * cap, d)
    g = torch.bmm(xe, w_gate.to(x.dtype))
    u = torch.bmm(xe, w_up.to(x.dtype))
    ye = torch.bmm(_act(g, cfg.act) * u, w_down.to(x.dtype))
    ye = ye.view(El, B, cap, d)

    # combine: each kept assignment reads its expert's output at its slot,
    # weighted in ye's dtype, summed over k; a dropped one reads slot
    # (0, 0) at weight 0
    e = torch.where(keep, topk_idx, 0)
    c = torch.where(keep, slot, 0)
    b = torch.arange(B, device=x.device)[:, None, None]
    w = torch.where(keep, topk_w, 0.0).to(ye.dtype)
    return (ye[e, b, c] * w[..., None]).sum(2)


def moe_block(params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), the load-balance loss: a scalar that
    serving discards)."""
    probs, topk_idx, topk_w = route(params["router"], x, cfg.moe)
    y = _expert_outputs(cfg, 0, x, topk_idx, topk_w, params["w_gate"],
                        params["w_up"], params["w_down"])
    if cfg.moe.num_shared:
        y = y + mlp_block(params["shared"], cfg.act, x)
    return y, load_balance_loss(probs, topk_idx, cfg.moe)


def moe_block_auto(params, cfg: ModelConfig,
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism when a ``logical_sharding`` context is open, x is
    a DTensor, the rules put ``experts`` on "model" and E divides it; else
    ``moe_block``."""
    ctx = shd.current()
    if ctx is not None and shd.is_distributed(x):
        mesh, rules = ctx
        ways = shd.mesh_sizes(mesh).get("model", 1)
        if rules.get("experts") == "model" and cfg.moe.num_experts % ways == 0:
            return moe_block_sharded(params, cfg, x, mesh)
    return moe_block(params, cfg, x)


def _local_part(cfg: ModelConfig, e0: int, share: float, x, router,
                w_gate, w_up, w_down) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's part: x (B,S,d) routed once, whole; the outputs of its
    experts (``_expert_outputs``) and its ``share`` of the load-balance
    loss."""
    probs, topk_idx, topk_w = route(router, x, cfg.moe)
    y = _expert_outputs(cfg, e0, x, topk_idx, topk_w, w_gate, w_up, w_down)
    return y, load_balance_loss(probs, topk_idx, cfg.moe) * share


def moe_block_sharded(params, cfg: ModelConfig, x, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN on ``mesh`` (see the module docstring): x
    (B,S,d) DTensor -> (y (B,S,d) replicated over "model", the mesh-mean
    load-balance loss).

    One ``local_map`` routes each batch block once. Both outputs are
    Partial over "model": the experts' outputs are the ranks' parts of a
    sum, and each rank's load-balance loss is its block's loss over the
    number of ranks, so the gradients of x and the router are parts of
    a sum there too (Partial). Over the axes that split the batch, the
    loss is a part of the mean of the blocks' losses."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = shd.mesh_shape(mesh).axis_names
    ways = shd.mesh_sizes(mesh)["model"]
    El = cfg.moe.num_experts // ways
    e0 = mesh.get_local_rank("model") * El
    xt = tuple(p if n in shd.BATCH_AXES and p == Shard(0) else Replicate()
               for n, p in zip(names, x.placements))
    whole = (Replicate(),) * len(names)
    experts = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    on_model = tuple(Partial() if n == "model" else p
                     for n, p in zip(names, xt))
    n_parts = math.prod(mesh.size(i) for i, (n, p) in enumerate(zip(names, xt))
                        if n == "model" or isinstance(p, Shard))
    parts = tuple(Partial() if n == "model" or isinstance(p, Shard)
                  else Replicate() for n, p in zip(names, xt))
    y, aux = shd.local_kernel(
        lambda *a: _local_part(cfg, e0, 1.0 / n_parts, *a),
        [x, params["router"], params["w_gate"], params["w_up"],
         params["w_down"]], [xt, whole, experts, experts, experts],
        [on_model, parts], mesh=mesh,
        grads=[on_model, shd.weight_grad_placements(
            tuple(Partial() if n == "model" else Replicate() for n in names),
            xt)] + [shd.weight_grad_placements(experts, xt)] * 3)
    y = constrain(y, ("batch", "seq", "embed"))
    if cfg.moe.num_shared:
        y = y + mlp_block(params["shared"], cfg.act, x)
    return y, aux
