"""The decoder stack: parameters, whole-prompt prefill and the paged
incremental paths (decode, speculative verify, chunked prefill).

The port of the dense, recurrent (RG-LRU) and SSM (Mamba-2) parts of
``repro/models/transformer.py``.
The reference scans a stacked ``params["blocks"]`` with a leading
repetition axis; the port holds one parameter dict per layer in
``params["layers"]`` (prefix, then the pattern repetitions, then the
suffix, in the reference's order) and loops over them, and keeps one
cache entry per layer in a list. ``convert.params_from_jax`` unstacks the
reference's tree into this layout.

Attention layers keep a page pool each; recurrent and SSM layers keep
O(1) slot-major state (float32, one row per request slot), which the
paged paths update in place: a decode step only in the rows of active
slots, a chunk of a prompt only in its slot's row (zeroed first when the
chunk starts the prompt), and a speculative verify not at all — it
returns the state after every proposed token, stacked on a leading T
axis, and ``serve.state.select_verified`` keeps each slot's snapshot at
its last accepted token.

MoE, QK norms, the audio/vision front ends and the contribution gate are
not ported: the stack raises ``NotImplementedError`` where a config would
need them.

Every kernel the stack runs is named by ``ops`` (``KERNELS``): paged
attention, the causal conv1d, the SSD chunk and local attention, the
last three where the reference computes the same function inline in
plain JAX. ``ops=PLAIN`` serves only to check the kernels' run against
their plain versions on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import (
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, SSM, ModelConfig,
)
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
from repro_torch.kernels.local_attn.ops import local_attention_fused
from repro_torch.kernels.local_attn.ref import local_attention_ref
from repro_torch.kernels.paged_attn.ops import paged_attention_fused
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.layers import apply_norm, embed, unembed

LayerKind = str
Params = Dict[str, Any]


class KernelOps(NamedTuple):
    """The kernels the stack calls."""
    paged_attn: Callable      # attention over the page pool
    conv1d: Callable          # causal depthwise conv of RG-LRU and SSM layers
    ssd_chunk: Callable       # SSD intra-chunk steps of a whole-prompt SSM
    local_attn: Callable      # whole-prompt attention of a local layer


# The stack's kernels: the Hopper kernels on CUDA tensors, their plain
# versions on CPU tensors.
KERNELS = KernelOps(paged_attention_fused, causal_conv1d, ssd_chunk_fused,
                    local_attention_fused)
# The plain versions on any device: only for holding the kernels' run
# against them on the card.
PLAIN = KernelOps(paged_attention_ref, causal_conv1d_ref, ssd_chunk_ref,
                  local_attention_ref)


# ---------------------------------------------------------------------------
# Stack structure
# ---------------------------------------------------------------------------
def stack_plan(cfg: ModelConfig):
    """Return (prefix_kinds, pattern, n_rep, suffix_kinds)."""
    kinds = cfg.layer_kinds()
    k = cfg.first_k_dense
    if k and len(set(cfg.layer_pattern)) != 1:
        raise ValueError("first_k_dense requires a uniform layer pattern")
    prefix = kinds[:k]
    rest = kinds[k:]
    pat = cfg.layer_pattern
    n_rep = len(rest) // len(pat)
    suffix = rest[n_rep * len(pat):]
    return prefix, pat, n_rep, suffix


def _ffn_kind(cfg: ModelConfig, kind: LayerKind, *, in_prefix: bool) -> str:
    if kind == SSM:
        return "none"                # mamba block has no separate FFN
    if cfg.moe is not None and not in_prefix:
        return "moe"
    return "dense" if cfg.d_ff else "none"


def layer_plan(cfg: ModelConfig) -> List[Tuple[LayerKind, str]]:
    """(kind, ffn) of every layer in stack order: prefix, pattern
    repetitions, suffix. Raises for what the port cannot run yet."""
    prefix, pat, n_rep, suffix = stack_plan(cfg)
    plan = [(k, _ffn_kind(cfg, k, in_prefix=True)) for k in prefix]
    plan += [(k, _ffn_kind(cfg, k, in_prefix=False))
             for _ in range(n_rep) for k in pat]
    plan += [(k, _ffn_kind(cfg, k, in_prefix=False)) for k in suffix]
    for kind, ffn in plan:
        if ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: moe layers are not ported yet (ROADMAP Queue A)")
    if cfg.frontend is not None or cfg.contribution_gate or cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: front ends, the contribution gate and QK norms "
            "are not ported yet (ROADMAP Queue A)")
    return plan


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ModelConfig, kind: LayerKind,
                  ffn: str) -> Dict[str, Any]:
    """{group: {leaf: (shape, init, scale)}} of one layer, the reference's
    layout (nested where the reference nests, as ``ssm/out_norm``)."""
    d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim())
    norm = _norm_shapes(cfg.norm, d)
    out: Dict[str, Any] = {"norm1": norm}
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        attn = {"wq": ((d, hq, dh), "normal", None),
                "wk": ((d, hkv, dh), "normal", None),
                "wv": ((d, hkv, dh), "normal", None),
                "wo": ((hq, dh, d), "normal", None)}
        if cfg.qkv_bias:
            attn.update(bq=((hq, dh), "zeros", None),
                        bk=((hkv, dh), "zeros", None),
                        bv=((hkv, dh), "zeros", None))
        out["attn"] = attn
    elif kind == RECURRENT:
        out["rec"] = rglru_mod.rglru_shapes(cfg)
    elif kind == SSM:
        out["ssm"] = ssm_mod.ssm_shapes(cfg)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        out["post_norm1"] = norm
    if ffn == "dense":
        out["norm2"] = norm
        out["ffn"] = {"w_gate": ((d, cfg.d_ff), "normal", None),
                      "w_up": ((d, cfg.d_ff), "normal", None),
                      "w_down": ((cfg.d_ff, d), "normal", None)}
        if cfg.post_norms:
            out["post_norm2"] = norm
    return out


def _norm_shapes(kind: str, dim: int) -> Dict[str, tuple]:
    if kind == "rmsnorm":
        return {"scale": ((dim,), "ones", None)}
    if kind == "layernorm":
        return {"scale": ((dim,), "ones", None),
                "bias": ((dim,), "zeros", None)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(f"unknown norm '{kind}'")


def model_params(cfg: ModelConfig, make: Callable) -> Params:
    """The parameter tree, each leaf made by ``make(shape, init, scale)``
    in the reference's order."""
    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return make(*tree)
    p: Params = {"embed": {"embedding": make(
        (cfg.padded_vocab(), cfg.d_model), "embed", 0.02)}}
    if not cfg.tie_embeddings:
        p["embed"]["unembed"] = make((cfg.d_model, cfg.padded_vocab()),
                                     "embed", 0.02)
    p["final_norm"] = build(_norm_shapes(cfg.norm, cfg.d_model))
    p["layers"] = [build(_layer_shapes(cfg, kind, ffn))
                   for kind, ffn in layer_plan(cfg)]
    return p


def init(cfg: ModelConfig, generator: torch.Generator,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random params on the generator's device, by the reference's
    ``ParamFactory`` law: normal with std 1/sqrt(shape[-2]) (its fan-in
    rule: ``wq`` (d, Hq, D) gets 1/sqrt(Hq)), the embedding normal with
    std 0.02, ``A_log`` and ``lam`` uniform on [-1, 1], biases 0 and norm
    scales (and the SSM skip ``D``) 1. The bits differ from JAX's."""
    device = generator.device

    def make(shape, kind, scale):
        if kind == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if kind == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if kind == "uniform":
            lim = scale or 1.0 / max(shape[-1], 1) ** 0.5
            t = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=device)
            return ((2 * t - 1) * lim).to(dtype)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / max(fan_in, 1) ** 0.5
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (t * scale).to(dtype)
    return model_params(cfg, make)


# read in float32 by the reference whatever the activation dtype (the SSM
# decode step reads D in float32, its prefill in the activation dtype)
_FLOAT32_LEAVES = ("A_log", "D", "lam")


def cast_params(params: Params, dtype: torch.dtype,
                device: Optional[torch.device] = None) -> Params:
    """The params as the serving state holds them: projection, bias, conv,
    MLP and embedding weights in the activation dtype, cast once here
    where the reference casts them at every use; norm scales and the
    leaves the reference reads in float32 (the SSM's ``A_log`` and ``D``,
    the RG-LRU's ``lam``) kept in float32."""
    def one(key, t):
        keep32 = "norm" in key or key.rsplit("/", 1)[-1] in _FLOAT32_LEAVES
        return t.to(device=device, dtype=torch.float32 if keep32 else dtype)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{key}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return one(key, tree).contiguous()
    return walk(params)


def embed_inputs(params: Params, cfg: ModelConfig,
                 inputs: Dict[str, torch.Tensor],
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding (the front ends are not ported)."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: {cfg.frontend} front end")
    return embed(params["embed"], inputs["tokens"], scale=cfg.embed_scale,
                 d_model=cfg.d_model, dtype=dtype)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def _apply_ffn(lp, cfg: ModelConfig, x: torch.Tensor, ffn: str):
    if ffn == "none":
        return x
    h = apply_norm(lp["norm2"], cfg.norm, x)
    out = mlp_mod.mlp_block(lp["ffn"], cfg, h)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm2"], cfg.norm, out)
    return x + out


def apply_layer(lp, cfg: ModelConfig, x: torch.Tensor, kind: LayerKind,
                ffn: str, *, max_len: int, ops: KernelOps = KERNELS):
    """Full-sequence layer for prefill, collecting its cache entry: the
    reference's ``collect_cache=True``. Returns (x, cache_entry): a KV
    ring for attention, the final state for recurrent and SSM layers.
    (The training forward is not ported yet.)"""
    h = apply_norm(lp["norm1"], cfg.norm, x)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        out, (k, v) = attn_mod.attention_block(lp["attn"], cfg, h, kind=kind,
                                               local=ops.local_attn)
        empty = attn_mod.init_kv_cache(
            x.shape[0], attn_mod.cache_length(cfg, kind, max_len),
            cfg.num_kv_heads, cfg.resolved_head_dim(), dtype=x.dtype,
            device=x.device)
        cache_entry = attn_mod.fill_cache_from_prefill(empty, k, v)
    elif kind == RECURRENT:
        out, cache_entry = rglru_mod.rglru_block(lp["rec"], cfg, h,
                                                 conv=ops.conv1d)
    elif kind == SSM:
        out, cache_entry = ssm_mod.ssm_block(lp["ssm"], cfg, h,
                                             conv=ops.conv1d,
                                             ssd=ops.ssd_chunk)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm1"], cfg.norm, out)
    return _apply_ffn(lp, cfg, x + out, ffn), cache_entry


def _apply_layer_step(lp, cfg: ModelConfig, x: torch.Tensor,
                      kind: LayerKind, ffn: str, mixer_fn):
    """Shared incremental-layer scaffold (norm -> mixer -> post-norm ->
    residual -> FFN); ``mixer_fn(lp, kind, h) -> (out, new_cache_entry)``
    supplies the cached attention or recurrent step."""
    h = apply_norm(lp["norm1"], cfg.norm, x)
    out, new_entry = mixer_fn(lp, kind, h)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm1"], cfg.norm, out)
    return _apply_ffn(lp, cfg, x + out, ffn), new_entry


def run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              max_len: int, ops: KernelOps = KERNELS):
    """x (B,S,d) -> (final-normed x, per-layer caches of ``max_len``)."""
    caches = []
    for lp, (kind, ffn) in zip(params["layers"], layer_plan(cfg)):
        x, c = apply_layer(lp, cfg, x, kind, ffn, max_len=max_len, ops=ops)
        caches.append(c)
    return apply_norm(params["final_norm"], cfg.norm, x), caches


# ---------------------------------------------------------------------------
# Prefill / incremental paths
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            max_len: int, *, dtype=torch.bfloat16, ops: KernelOps = KERNELS):
    """Full-context forward; returns (last-token logits (B,V), caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)
    x, caches = run_stack(params, cfg, x, max_len=max_len, ops=ops)
    logits = unembed(params["embed"], x[:, -1:], tie=cfg.tie_embeddings,
                     cap=cfg.logit_softcap, real_vocab=cfg.vocab_size)[:, 0]
    return logits, caches


def _decode_walk(params: Params, cfg: ModelConfig, x: torch.Tensor, caches,
                 layer_fn):
    """Layer-by-layer traversal for the incremental paths; ``layer_fn(lp,
    kind, ffn, cache_entry, x) -> (x, new_entry)`` supplies the step."""
    new_caches = []
    for lp, (kind, ffn), ce in zip(params["layers"], layer_plan(cfg), caches):
        x, ne = layer_fn(lp, kind, ffn, ce, x)
        new_caches.append(ne)
    return x, new_caches


def _finish_logits(params: Params, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], cfg.norm, x)
    return unembed(params["embed"], x, tie=cfg.tie_embeddings,
                   cap=cfg.logit_softcap, real_vocab=cfg.vocab_size)


def _window(cfg: ModelConfig, kind: LayerKind) -> Optional[int]:
    return cfg.window if kind == ATTN_LOCAL else None


def _steps(kind: LayerKind, lp):
    """The recurrent form of a recurrent or SSM layer: (steps function,
    its params)."""
    if kind == RECURRENT:
        return rglru_mod.rglru_steps, lp["rec"]
    if kind == SSM:
        return ssm_mod.ssm_steps, lp["ssm"]
    raise ValueError(kind)


def _mask_state_update(new_entry, old_entry, active: torch.Tensor):
    """Write ``new_entry`` into ``old_entry`` IN PLACE in the rows where
    ``active`` (S,) is True and keep the old rows elsewhere, so the fused
    all-slot decode step cannot advance the recurrent state of a free slot
    or of a slot that is mid-chunked-prefill. Returns ``old_entry``."""
    for n, o in zip(new_entry, old_entry):
        m = active.reshape((-1,) + (1,) * (n.dim() - 1))
        o.copy_(torch.where(m, n.to(o.dtype), o))
    return old_entry


def decode_step_paged(params: Params, cfg: ModelConfig,
                      inputs: Dict[str, torch.Tensor], caches,
                      position: torch.Tensor, page_table: torch.Tensor,
                      active: torch.Tensor, *, dtype=torch.bfloat16,
                      ops: KernelOps = KERNELS):
    """Fused all-slot decode against the paged cache. ``page_table``
    (S, pages_per_slot) int32 page ids per slot (-1 unassigned);
    ``active`` (S,) bool gates every state write: inactive slots neither
    write KV pages nor advance recurrent state. Returns (logits (S,V),
    caches updated in place)."""
    x = embed_inputs(params, cfg, inputs, dtype)

    def layer_fn(lp, kind, ffn, ce, xx):
        def mixer(lp_, kind_, h):
            if kind_ in (ATTN_GLOBAL, ATTN_LOCAL):
                return attn_mod.paged_decode_attention(
                    lp_["attn"], cfg, h, ce, page_table, position,
                    window=_window(cfg, kind_), active=active,
                    attn=ops.paged_attn)
            steps, p = _steps(kind_, lp_)
            out, ne = steps(p, cfg, h, ce, conv=ops.conv1d)
            return out, _mask_state_update(ne, ce, active)
        return _apply_layer_step(lp, cfg, xx, kind, ffn, mixer)

    x, new_caches = _decode_walk(params, cfg, x, caches, layer_fn)
    return _finish_logits(params, cfg, x)[:, 0], new_caches


def verify_step_paged(params: Params, cfg: ModelConfig,
                      inputs: Dict[str, torch.Tensor], caches,
                      position: torch.Tensor, page_table: torch.Tensor,
                      active: torch.Tensor, *, dtype=torch.bfloat16,
                      ops: KernelOps = KERNELS):
    """Draft verification: one fused step over ALL slots.
    ``inputs["tokens"]`` (S, T) holds, per slot, the last accepted token
    followed by T-1 drafted tokens, starting at the slot's ``position``.
    Attention layers write all T tokens' K/V into the slot's pages —
    rejected positions need no undo, the position mask hides them.
    Recurrent and SSM layers leave their state untouched and return it
    after every proposed token, stacked on a leading T axis (the
    reference's ``_verify_recurrent``), for ``select_verified``.
    Returns (logits (S, T, V) at every proposed position, caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)

    def layer_fn(lp, kind, ffn, ce, xx):
        def mixer(lp_, kind_, h):
            if kind_ in (ATTN_GLOBAL, ATTN_LOCAL):
                return attn_mod.paged_multitok_attention(
                    lp_["attn"], cfg, h, ce, page_table, position,
                    window=_window(cfg, kind_), active=active,
                    attn=ops.paged_attn)
            steps, p = _steps(kind_, lp_)
            return steps(p, cfg, h, ce, snapshots=True, conv=ops.conv1d)
        return _apply_layer_step(lp, cfg, xx, kind, ffn, mixer)

    x, new_caches = _decode_walk(params, cfg, x, caches, layer_fn)
    return _finish_logits(params, cfg, x), new_caches


def _chunk_recurrent(steps, p, cfg: ModelConfig, x: torch.Tensor, entry,
                     slot: int, pos_start: int, conv: Callable):
    """Run a recurrent/SSM layer over a chunk for ONE slot: take the
    slot's state row, step it over the chunk's tokens, and write the final
    state back into the row in place. The first chunk of a prompt
    (``pos_start == 0``) starts from zeros: the row may hold stale state
    from an evicted request."""
    row = type(entry)(*(t[slot:slot + 1] for t in entry))
    if int(pos_start) == 0:
        row = type(entry)(*(torch.zeros_like(t) for t in row))
    out, new = steps(p, cfg, x, row, conv=conv)
    for full, one in zip(entry, new):
        full[slot:slot + 1] = one.to(full.dtype)
    return out, entry


def prefill_chunk(params: Params, cfg: ModelConfig,
                  inputs: Dict[str, torch.Tensor], caches,
                  page_row: torch.Tensor, slot, pos_start, *,
                  dtype=torch.bfloat16, ops: KernelOps = KERNELS):
    """One chunked-prefill step for ONE request slot. ``inputs["tokens"]``
    (1, C) is the chunk starting at absolute position ``pos_start``; its
    KV goes into the slot's pages and recurrent state advances in the
    slot's row, so admission interleaves with fused decode steps without
    touching any other slot. Returns (last-token logits (1, V), caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)

    def layer_fn(lp, kind, ffn, ce, xx):
        def mixer(lp_, kind_, h):
            if kind_ in (ATTN_GLOBAL, ATTN_LOCAL):
                return attn_mod.paged_prefill_attention(
                    lp_["attn"], cfg, h, ce, page_row, pos_start,
                    window=_window(cfg, kind_), attn=ops.paged_attn)
            steps, p = _steps(kind_, lp_)
            return _chunk_recurrent(steps, p, cfg, h, ce, int(slot),
                                    pos_start, ops.conv1d)
        return _apply_layer_step(lp, cfg, xx, kind, ffn, mixer)

    x, new_caches = _decode_walk(params, cfg, x, caches, layer_fn)
    return _finish_logits(params, cfg, x)[:, -1], new_caches


def scatter_prefill_paged(cfg: ModelConfig, paged_caches, prefill_caches,
                          page_row: torch.Tensor, slot):
    """Write a whole-prompt prefill cache (from ``prefill``, batch 1) into
    the paged state, layer by layer, in place: KV rings map into the
    slot's pages, recurrent/SSM state goes into the slot's row."""
    for pooled, fresh in zip(paged_caches, prefill_caches):
        if isinstance(pooled, PagedKVCache):
            attn_mod.paged_fill_from_prefill(pooled, fresh, page_row)
        else:
            for full, one in zip(pooled, fresh):
                full[int(slot)] = one[0].to(full.dtype)
    return paged_caches


def init_paged_cache(cfg: ModelConfig, slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16, device="cpu"):
    """Per layer: a page pool of ``num_pages`` pages (plus the sink) for an
    attention layer, so slot count is decoupled from cache length and
    memory follows live tokens; O(1) slot-major float32 state for a
    recurrent or SSM layer. (mamba2 has no attention layer, so no pool.)"""
    def one(kind):
        if kind == RECURRENT:
            return rglru_mod.init_rglru_state(cfg, slots, device=device)
        if kind == SSM:
            return ssm_mod.init_ssm_state(cfg, slots, device=device)
        return attn_mod.init_paged_kv_cache(
            num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim(),
            dtype, device)
    return [one(kind) for kind, _ in layer_plan(cfg)]
