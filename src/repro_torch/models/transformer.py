"""The dense-decoder stack: parameters, whole-prompt prefill and the paged
incremental paths (decode, speculative verify, chunked prefill).

The port of the dense-decoder subset of ``repro/models/transformer.py``.
The reference scans a stacked ``params["blocks"]`` with a leading
repetition axis; the port holds one parameter dict per layer in
``params["layers"]`` (prefix, then the pattern repetitions, then the
suffix, in the reference's order) and loops over them, and keeps one
cache entry per layer in a list. ``convert.params_from_jax`` unstacks the
reference's tree into this layout.

Recurrent (RG-LRU), SSM, MoE, QK norms, the audio/vision front ends and
the contribution gate are not ported: the stack raises
``NotImplementedError`` where a config would need them.

Every attention over the page pool goes through the paged-attention
kernel's wrapper named by ``ops`` (``KERNELS``); ``ops=PLAIN`` serves only
to check the kernel's run against its plain version on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import (
    ATTN_LOCAL, RECURRENT, SSM, ModelConfig,
)
from repro_torch.kernels.paged_attn.ops import paged_attention_fused
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import apply_norm, embed, unembed

LayerKind = str
Params = Dict[str, Any]


class KernelOps(NamedTuple):
    """The kernel the paged paths call."""
    paged_attn: Callable


# The stack's kernel: the Hopper kernel on CUDA tensors, its plain version
# on CPU tensors.
KERNELS = KernelOps(paged_attention_fused)
# The plain version on any device: only for holding the kernel's run
# against it on the card.
PLAIN = KernelOps(paged_attention_ref)


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
        if kind in (RECURRENT, SSM) or ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: {'moe' if ffn == 'moe' else kind} layers are "
                "not ported yet (ROADMAP Queue A)")
    if cfg.frontend is not None or cfg.contribution_gate or cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: front ends, the contribution gate and QK norms "
            "are not ported yet (ROADMAP Queue A)")
    return plan


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ModelConfig, ffn: str) -> Dict[str, Dict[str, tuple]]:
    """{group: {leaf: (shape, init)}} of one layer, the reference's layout."""
    d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim())
    norm = _norm_shapes(cfg.norm, d)
    attn = {"wq": ((d, hq, dh), "normal"), "wk": ((d, hkv, dh), "normal"),
            "wv": ((d, hkv, dh), "normal"), "wo": ((hq, dh, d), "normal")}
    if cfg.qkv_bias:
        attn.update(bq=((hq, dh), "zeros"), bk=((hkv, dh), "zeros"),
                    bv=((hkv, dh), "zeros"))
    out = {"norm1": norm, "attn": attn}
    if cfg.post_norms:
        out["post_norm1"] = norm
    if ffn == "dense":
        out["norm2"] = norm
        out["ffn"] = {"w_gate": ((d, cfg.d_ff), "normal"),
                      "w_up": ((d, cfg.d_ff), "normal"),
                      "w_down": ((cfg.d_ff, d), "normal")}
        if cfg.post_norms:
            out["post_norm2"] = norm
    return out


def _norm_shapes(kind: str, dim: int) -> Dict[str, tuple]:
    if kind == "rmsnorm":
        return {"scale": ((dim,), "ones")}
    if kind == "layernorm":
        return {"scale": ((dim,), "ones"), "bias": ((dim,), "zeros")}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(f"unknown norm '{kind}'")


def model_params(cfg: ModelConfig, make: Callable) -> Params:
    """The parameter tree, each leaf made by ``make(shape, init, scale)``."""
    def group(shapes):
        return {g: {k: make(s, init, None) for k, (s, init) in leaves.items()}
                for g, leaves in shapes.items()}
    p: Params = {"embed": {"embedding": make(
        (cfg.padded_vocab(), cfg.d_model), "embed", 0.02)}}
    if not cfg.tie_embeddings:
        p["embed"]["unembed"] = make((cfg.d_model, cfg.padded_vocab()),
                                     "embed", 0.02)
    p["final_norm"] = {k: make(s, init, None) for k, (s, init)
                       in _norm_shapes(cfg.norm, cfg.d_model).items()}
    p["layers"] = [group(_layer_shapes(cfg, ffn))
                   for _, ffn in layer_plan(cfg)]
    return p


def init(cfg: ModelConfig, generator: torch.Generator,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random params on the generator's device, by the reference's
    ``ParamFactory`` law: normal with std 1/sqrt(shape[-2]) (its fan-in
    rule: ``wq`` (d, Hq, D) gets 1/sqrt(Hq)), the embedding normal with
    std 0.02, biases 0 and norm scales 1. The bits differ from JAX's."""
    device = generator.device

    def make(shape, kind, scale):
        if kind == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if kind == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / max(fan_in, 1) ** 0.5
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (t * scale).to(dtype)
    return model_params(cfg, make)


def cast_params(params: Params, dtype: torch.dtype,
                device: Optional[torch.device] = None) -> Params:
    """The params as the serving state holds them: projection, bias, MLP
    and embedding weights in the activation dtype, cast once here where
    the reference casts them at every use; norm scales kept in float32."""
    def one(key, t):
        keep32 = "norm" in key
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
                ffn: str, *, max_len: int):
    """Full-sequence layer for prefill, collecting its cache entry: the
    reference's ``collect_cache=True``. Returns (x, cache_entry). (The
    training forward is not ported yet.)"""
    h = apply_norm(lp["norm1"], cfg.norm, x)
    out, (k, v) = attn_mod.attention_block(lp["attn"], cfg, h, kind=kind)
    empty = attn_mod.init_kv_cache(
        x.shape[0], attn_mod.cache_length(cfg, kind, max_len),
        cfg.num_kv_heads, cfg.resolved_head_dim(), dtype=x.dtype,
        device=x.device)
    cache_entry = attn_mod.fill_cache_from_prefill(empty, k, v)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm1"], cfg.norm, out)
    return _apply_ffn(lp, cfg, x + out, ffn), cache_entry


def _apply_layer_step(lp, cfg: ModelConfig, x: torch.Tensor,
                      kind: LayerKind, ffn: str, mixer_fn):
    """Shared incremental-layer scaffold (norm -> mixer -> post-norm ->
    residual -> FFN); ``mixer_fn(lp, kind, h) -> (out, new_cache_entry)``
    supplies the cached attention step."""
    h = apply_norm(lp["norm1"], cfg.norm, x)
    out, new_entry = mixer_fn(lp, kind, h)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm1"], cfg.norm, out)
    return _apply_ffn(lp, cfg, x + out, ffn), new_entry


def run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              max_len: int):
    """x (B,S,d) -> (final-normed x, per-layer caches of ``max_len``)."""
    caches = []
    for lp, (kind, ffn) in zip(params["layers"], layer_plan(cfg)):
        x, c = apply_layer(lp, cfg, x, kind, ffn, max_len=max_len)
        caches.append(c)
    return apply_norm(params["final_norm"], cfg.norm, x), caches


# ---------------------------------------------------------------------------
# Prefill / incremental paths
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            max_len: int, *, dtype=torch.bfloat16):
    """Full-context forward; returns (last-token logits (B,V), caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)
    x, caches = run_stack(params, cfg, x, max_len=max_len)
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


def decode_step_paged(params: Params, cfg: ModelConfig,
                      inputs: Dict[str, torch.Tensor], caches,
                      position: torch.Tensor, page_table: torch.Tensor,
                      active: torch.Tensor, *, dtype=torch.bfloat16,
                      ops: KernelOps = KERNELS):
    """Fused all-slot decode against the paged cache. ``page_table``
    (S, pages_per_slot) int32 page ids per slot (-1 unassigned);
    ``active`` (S,) bool gates every KV write. Returns (logits (S,V),
    caches updated in place)."""
    x = embed_inputs(params, cfg, inputs, dtype)

    def layer_fn(lp, kind, ffn, ce, xx):
        def mixer(lp_, kind_, h):
            return attn_mod.paged_decode_attention(
                lp_["attn"], cfg, h, ce, page_table, position,
                window=_window(cfg, kind_), active=active,
                attn=ops.paged_attn)
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
    Returns (logits (S, T, V) at every proposed position, caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)

    def layer_fn(lp, kind, ffn, ce, xx):
        def mixer(lp_, kind_, h):
            return attn_mod.paged_multitok_attention(
                lp_["attn"], cfg, h, ce, page_table, position,
                window=_window(cfg, kind_), active=active,
                attn=ops.paged_attn)
        return _apply_layer_step(lp, cfg, xx, kind, ffn, mixer)

    x, new_caches = _decode_walk(params, cfg, x, caches, layer_fn)
    return _finish_logits(params, cfg, x), new_caches


def prefill_chunk(params: Params, cfg: ModelConfig,
                  inputs: Dict[str, torch.Tensor], caches,
                  page_row: torch.Tensor, slot, pos_start, *,
                  dtype=torch.bfloat16, ops: KernelOps = KERNELS):
    """One chunked-prefill step for ONE request slot. ``inputs["tokens"]``
    (1, C) is the chunk starting at absolute position ``pos_start``; its
    KV goes into the slot's pages. ``slot`` places recurrent state in the
    reference; attention-only stacks keep nothing per slot. Returns
    (last-token logits (1, V), caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)

    def layer_fn(lp, kind, ffn, ce, xx):
        def mixer(lp_, kind_, h):
            return attn_mod.paged_prefill_attention(
                lp_["attn"], cfg, h, ce, page_row, pos_start,
                window=_window(cfg, kind_), attn=ops.paged_attn)
        return _apply_layer_step(lp, cfg, xx, kind, ffn, mixer)

    x, new_caches = _decode_walk(params, cfg, x, caches, layer_fn)
    return _finish_logits(params, cfg, x)[:, -1], new_caches


def scatter_prefill_paged(cfg: ModelConfig, paged_caches, prefill_caches,
                          page_row: torch.Tensor, slot):
    """Write a whole-prompt prefill cache (from ``prefill``, batch 1) into
    the slot's pages, layer by layer, in place."""
    for pooled, fresh in zip(paged_caches, prefill_caches):
        attn_mod.paged_fill_from_prefill(pooled, fresh, page_row)
    return paged_caches


def init_paged_cache(cfg: ModelConfig, slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16, device="cpu"):
    """One page pool of ``num_pages`` pages (plus the sink) per layer:
    slot count is decoupled from cache length, memory follows live
    tokens. (Recurrent/SSM layers, which would keep slot-major state, are
    not ported.)"""
    return [attn_mod.init_paged_kv_cache(
        num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim(),
        dtype, device) for _ in layer_plan(cfg)]
