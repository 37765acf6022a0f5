"""The decoder stack: parameters, the training forward and loss,
whole-prompt prefill and the paged incremental paths (decode,
speculative verify, chunked prefill).

The port of ``repro/models/transformer.py``: its dense,
mixture-of-experts, recurrent (RG-LRU), SSM (Mamba-2), front-end and
encoder parts, with the paged cache and the contiguous one (the
reference's parity baseline: ``init_cache``, ``decode_step``).
The reference scans a stacked ``params["blocks"]`` with a leading
repetition axis; the port holds one parameter dict per layer in
``params["layers"]`` (prefix, then the pattern repetitions, then the
suffix, in the reference's order) and loops over them, and keeps one
cache entry per layer in a list. ``convert.params_from_jax`` unstacks the
reference's tree into this layout.

The cache is a list of one entry a layer: ``init_cache`` gives each
attention layer a ring of ``max_len`` slots (a local layer's window),
``init_paged_cache`` a page pool; ``cache_axes``/``paged_cache_axes`` give
the logical axes of each entry's leaves (the reference's trees put a
leading repetition axis on the scanned blocks' leaves, which the port's
list does not have; ``serve/state.py::cache_leaves`` maps the two).

Attention layers keep a page pool each; recurrent and SSM layers keep
O(1) slot-major state (float32, one row per request slot), which the
paged paths update in place: a decode step only in the rows of active
slots, a chunk of a prompt only in its slot's row (zeroed first when the
chunk starts the prompt), and a speculative verify not at all — it
returns the state after every proposed token, stacked on a leading T
axis, and ``serve.state.select_verified`` keeps each slot's snapshot at
its last accepted token.

The training forward (``forward``, ``lm_loss``) collects no cache: a
global layer runs ``attention.blockq_attention``, a local layer the
local-attention kernel, and ``run_stack`` sums the MoE layers' load
balance loss and, with ``remat``, checkpoints each repetition of the
layer pattern (not the prefix or the suffix), as the reference
checkpoints its scanned ``blocks`` body. On the card the kernels' wrappers
take their autograd Functions there: each kernel runs the forward and
autograd through its plain version the backward.

A MoE layer's FFN is ``models/moe.py``'s ``moe_block`` (deepseek-moe's
first ``first_k_dense`` layers keep a dense FFN); QK norm is in
``attention.qkv_project``. The front ends are in ``embed_inputs``:
hubert-xlarge's audio stub projects precomputed frames and adds the
sinusoidal table (an encoder: ``causal=False`` reaches the attention
calls, and it has no decode path), internvl2-2b's vision stub projects
precomputed patches through a two-layer GELU MLP and puts them before the
text tokens; a step without patches (decode, verify, a chunk) embeds
tokens only, and ``lm_loss`` drops the image positions. With
``cfg.contribution_gate`` every path scales the embedded stream by
``core/gating.py``'s per-token weight before the first layer, as the
reference's ``run_stack`` and paged steps do.

Every kernel the stack runs is named by ``ops`` (``KERNELS``): paged
attention, the causal conv1d, the SSD chunk and local attention, the
last three where the reference computes the same function inline in
plain JAX. ``ops=PLAIN`` serves only to check the kernels' run against
their plain versions on the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, SSM, ModelConfig,
)
from repro_torch.core.gating import contribution_gate, gate_shapes
from repro_torch.distributed import sharding as shd
from repro_torch.core.gating import param_specs as gate_specs
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
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.layers import (
    apply_norm, embed, norm_specs, sinusoidal_positions, unembed,
)
from repro_torch.models.layers import param_specs as layers_specs

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
    repetitions, suffix."""
    prefix, pat, n_rep, suffix = stack_plan(cfg)
    plan = [(k, _ffn_kind(cfg, k, in_prefix=True)) for k in prefix]
    plan += [(k, _ffn_kind(cfg, k, in_prefix=False))
             for _ in range(n_rep) for k in pat]
    plan += [(k, _ffn_kind(cfg, k, in_prefix=False)) for k in suffix]
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
        if cfg.qk_norm:
            attn.update(q_norm=_norm_shapes("rmsnorm", dh),
                        k_norm=_norm_shapes("rmsnorm", dh))
        out["attn"] = attn
    elif kind == RECURRENT:
        out["rec"] = rglru_mod.rglru_shapes(cfg)
    elif kind == SSM:
        out["ssm"] = ssm_mod.ssm_shapes(cfg)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        out["post_norm1"] = norm
    if ffn != "none":
        out["norm2"] = norm
        out["ffn"] = (mlp_mod.mlp_shapes(d, cfg.d_ff) if ffn == "dense"
                      else moe_mod.moe_shapes(cfg))
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


def _frontend_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The front end's leaves: the audio stub's frame projection, or the
    vision stub's two-layer patch projector; biases zero."""
    fd, d = cfg.frontend_dim, cfg.d_model
    if cfg.frontend == "audio_stub":
        return {"proj": ((fd, d), "normal", None),
                "proj_b": ((d,), "zeros", None)}
    if cfg.frontend == "vision_stub":
        return {"w1": ((fd, d), "normal", None), "b1": ((d,), "zeros", None),
                "w2": ((d, d), "normal", None), "b2": ((d,), "zeros", None)}
    raise ValueError(f"unknown front end '{cfg.frontend}'")


def model_params(cfg: ModelConfig, make: Callable) -> Params:
    """The parameter tree, each leaf made by ``make(shape, init, scale,
    key)`` in the reference's order; ``key`` is the leaf's '/'-joined
    path (``/layers/ffn/router``). The contribution gate (``gate``) and
    the front end (``frontend``) sit beside the embedding, as in the
    reference's tree."""
    def build(tree, key):
        if isinstance(tree, dict):
            return {k: build(v, f"{key}/{k}") for k, v in tree.items()}
        return make(*tree, key)
    p: Params = {"embed": {"embedding": make(
        (cfg.padded_vocab(), cfg.d_model), "embed", 0.02,
        "/embed/embedding")}}
    if not cfg.tie_embeddings:
        p["embed"]["unembed"] = make((cfg.d_model, cfg.padded_vocab()),
                                     "embed", 0.02, "/embed/unembed")
    p["final_norm"] = build(_norm_shapes(cfg.norm, cfg.d_model),
                            "/final_norm")
    if cfg.contribution_gate:
        p["gate"] = build(gate_shapes(cfg.d_model), "/gate")
    if cfg.frontend is not None:
        p["frontend"] = build(_frontend_shapes(cfg), "/frontend")
    p["layers"] = [build(_layer_shapes(cfg, kind, ffn), "/layers")
                   for kind, ffn in layer_plan(cfg)]
    return p


def _layer_specs(cfg: ModelConfig, kind: LayerKind, ffn: str
                 ) -> Dict[str, Any]:
    """The logical axes of ``_layer_shapes``' leaves."""
    norm = norm_specs(cfg.norm)
    out: Dict[str, Any] = {"norm1": norm}
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        out["attn"] = attn_mod.param_specs(cfg)
    elif kind == RECURRENT:
        out["rec"] = rglru_mod.param_specs(cfg)
    elif kind == SSM:
        out["ssm"] = ssm_mod.param_specs(cfg)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        out["post_norm1"] = norm
    if ffn != "none":
        out["norm2"] = norm
        out["ffn"] = (mlp_mod.param_specs() if ffn == "dense"
                      else moe_mod.param_specs(cfg))
        if cfg.post_norms:
            out["post_norm2"] = norm
    return out


def param_specs(cfg: ModelConfig) -> Params:
    """The logical-axes tree of ``model_params``: the reference's
    ``param_specs`` in the port's per-layer layout (one dict a layer where
    the reference stacks the repetitions on a leading unnamed axis)."""
    p: Params = {"embed": layers_specs(cfg),
                 "final_norm": norm_specs(cfg.norm)}
    if cfg.contribution_gate:
        p["gate"] = gate_specs()
    if cfg.frontend == "audio_stub":
        p["frontend"] = {"proj": (None, "embed"), "proj_b": ("embed",)}
    elif cfg.frontend == "vision_stub":
        p["frontend"] = {"w1": (None, "embed"), "b1": ("embed",),
                         "w2": ("embed", None), "b2": ("embed",)}
    p["layers"] = [_layer_specs(cfg, kind, ffn)
                   for kind, ffn in layer_plan(cfg)]
    return p


def flat_param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """``param_specs`` keyed as the LM engine keeps its params
    (``convert.flatten``'s '/'-joined paths), each with the engine's
    leading replica axis of 1 (``None``)."""
    def walk(t, key):
        if isinstance(t, list):
            t = {str(i): v for i, v in enumerate(t)}
        for k, v in t.items():
            path = f"{key}/{k}" if key else k
            if isinstance(v, tuple):
                yield path, (None,) + v
            else:
                yield from walk(v, path)
    return dict(walk(param_specs(cfg), ""))


def init(cfg: ModelConfig, generator: torch.Generator,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random params on the generator's device, by the reference's
    ``ParamFactory`` law: normal with std 1/sqrt(shape[-2]) (its fan-in
    rule: ``wq`` (d, Hq, D) gets 1/sqrt(Hq)), the embedding and the MoE
    router normal with std 0.02, ``A_log`` and ``lam`` uniform on [-1, 1],
    biases 0 and norm scales (and the SSM skip ``D``) 1. The bits differ
    from JAX's. Each leaf is drawn in float32 and cast at once as
    ``cast_params`` casts it to ``dtype``, so the tree equals
    ``cast_params(init(cfg, generator), dtype)`` without a float32 copy
    of the whole model ever being held."""
    device = generator.device

    def make(shape, kind, scale, key):
        out = torch.float32 if _keeps_float32(key) else dtype
        if kind == "zeros":
            return torch.zeros(shape, dtype=out, device=device)
        if kind == "ones":
            return torch.ones(shape, dtype=out, device=device)
        if kind == "uniform":
            lim = scale or 1.0 / max(shape[-1], 1) ** 0.5
            t = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=device)
            return ((2 * t - 1) * lim).to(out)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / max(fan_in, 1) ** 0.5
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (t * scale).to(out)
    return model_params(cfg, make)


# read in float32 by the reference whatever the activation dtype (the SSM
# decode step reads D in float32, its prefill in the activation dtype; the
# MoE router runs in float32)
_FLOAT32_LEAVES = ("A_log", "D", "lam", "router")


def _keeps_float32(key: str) -> bool:
    """Whether the leaf at path ``key`` stays float32 in any dtype: norm
    scales and ``_FLOAT32_LEAVES``."""
    return "norm" in key or key.rsplit("/", 1)[-1] in _FLOAT32_LEAVES


def cast_params(params: Params, dtype: torch.dtype,
                device: Optional[torch.device] = None) -> Params:
    """The params as the serving state holds them: projection, bias, conv,
    MLP, expert and embedding weights in the activation dtype, cast once
    here where the reference casts them at every use; norm scales and the
    leaves the reference reads in float32 (the SSM's ``A_log`` and ``D``,
    the RG-LRU's ``lam``, the MoE router) kept in float32."""
    def one(key, t):
        keep32 = _keeps_float32(key)
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
    """(B, S, d) in ``dtype``: the token embedding; for the audio stub,
    ``frames`` (B, S, Fd) projected, plus the bias and the sinusoidal
    table; for the vision stub with ``patches`` (B, P, Fd),
    ``gelu(patches w1 + b1) w2 + b2`` (the tanh GELU, JAX's default)
    before the tokens' embedding. Every step in ``dtype``, as the
    reference casts its inputs."""
    if cfg.frontend == "audio_stub":
        f = params["frontend"]
        x = inputs["frames"].to(dtype) @ f["proj"].to(dtype)
        x = x + f["proj_b"].to(dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(dtype)[None]
        return shd.constrain(x, ("batch", "seq", "embed"))
    txt = embed(params["embed"], inputs["tokens"], scale=cfg.embed_scale,
                d_model=cfg.d_model, dtype=dtype)
    if cfg.frontend == "vision_stub" and "patches" in inputs:
        f = params["frontend"]
        h = F.gelu(inputs["patches"].to(dtype) @ f["w1"].to(dtype)
                   + f["b1"].to(dtype), approximate="tanh")
        img = h @ f["w2"].to(dtype) + f["b2"].to(dtype)
        return shd.constrain(torch.cat([shd.pin_grad(img),
                                        shd.pin_grad(txt)], dim=1),
                             ("batch", "seq", "embed"))
    return txt


def _gated(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The embedded stream through the contribution gate, where the config
    has one."""
    return contribution_gate(params["gate"], x) if cfg.contribution_gate \
        else x


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def _apply_ffn(lp, cfg: ModelConfig, x: torch.Tensor, ffn: str):
    """(x + FFN(x), the MoE load-balance loss or None)."""
    if ffn == "none":
        return x, None
    h = apply_norm(lp["norm2"], cfg.norm, x)
    aux = None
    if ffn == "dense":
        out = mlp_mod.mlp_block(lp["ffn"], cfg, h)
    else:
        out, aux = moe_mod.moe_block_auto(lp["ffn"], cfg, h)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm2"], cfg.norm, out)
    return x + out, aux


def apply_layer(lp, cfg: ModelConfig, x: torch.Tensor, kind: LayerKind,
                ffn: str, *, collect_cache: bool = False, max_len: int = 0,
                ops: KernelOps = KERNELS):
    """Full-sequence layer. Returns (x, MoE aux or None, cache entry or
    None). With ``collect_cache`` (prefill) the cache entry is a KV ring
    of ``max_len`` for attention, the final state for recurrent and SSM
    layers; without it (training) a global layer attends by
    ``blockq_attention``."""
    h = apply_norm(lp["norm1"], cfg.norm, x)
    cache_entry = None
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        got = attn_mod.attention_block(lp["attn"], cfg, h, kind=kind,
                                       local=ops.local_attn,
                                       return_kv=collect_cache)
        if collect_cache:
            out, (k, v) = got
            empty = attn_mod.init_kv_cache(
                x.shape[0], attn_mod.cache_length(cfg, kind, max_len),
                cfg.num_kv_heads, cfg.resolved_head_dim(), dtype=x.dtype,
                device=x.device)
            cache_entry = attn_mod.fill_cache_from_prefill(empty, k, v)
        else:
            out = got
    elif kind == RECURRENT:
        out, state = rglru_mod.rglru_block(lp["rec"], cfg, h, conv=ops.conv1d)
    elif kind == SSM:
        out, state = ssm_mod.ssm_block(lp["ssm"], cfg, h, conv=ops.conv1d,
                                       ssd=ops.ssd_chunk)
    else:
        raise ValueError(kind)
    if collect_cache and kind in (RECURRENT, SSM):
        cache_entry = state
    if cfg.post_norms:
        out = apply_norm(lp["post_norm1"], cfg.norm, out)
    x, aux = _apply_ffn(lp, cfg, x + out, ffn)
    return x, aux, cache_entry


def _apply_layer_step(lp, cfg: ModelConfig, x: torch.Tensor,
                      kind: LayerKind, ffn: str, mixer_fn):
    """Shared incremental-layer scaffold (norm -> mixer -> post-norm ->
    residual -> FFN); ``mixer_fn(lp, kind, h) -> (out, new_cache_entry)``
    supplies the cached attention or recurrent step."""
    h = apply_norm(lp["norm1"], cfg.norm, x)
    out, new_entry = mixer_fn(lp, kind, h)
    if cfg.post_norms:
        out = apply_norm(lp["post_norm1"], cfg.norm, out)
    return _apply_ffn(lp, cfg, x + out, ffn)[0], new_entry


def apply_layer_decode(lp, cfg: ModelConfig, x: torch.Tensor,
                       kind: LayerKind, ffn: str, cache_entry, position, *,
                       ops: KernelOps = KERNELS):
    """One-token layer step against a contiguous ring (attention) or the
    slot-major state (recurrent, SSM: every row advances, in place).
    Returns (x, the cache entry, updated in place)."""
    def mixer(lp_, kind_, h):
        if kind_ in (ATTN_GLOBAL, ATTN_LOCAL):
            return attn_mod.decode_attention(
                lp_["attn"], cfg, h, cache_entry, position,
                window=_window(cfg, kind_))
        steps, p = _steps(kind_, lp_)
        out, ne = steps(p, cfg, h, cache_entry, conv=ops.conv1d)
        for n, o in zip(ne, cache_entry):
            o.copy_(n.to(o.dtype))
        return out, cache_entry
    return _apply_layer_step(lp, cfg, x, kind, ffn, mixer)


def run_prefill_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      max_len: int, ops: KernelOps = KERNELS):
    """x (B,S,d) -> (final-normed x, per-layer caches of ``max_len``),
    the contribution gate first."""
    x = _gated(params, cfg, x)
    caches = []
    for lp, (kind, ffn) in zip(params["layers"], layer_plan(cfg)):
        x, _, c = apply_layer(lp, cfg, x, kind, ffn, collect_cache=True,
                              max_len=max_len, ops=ops)
        caches.append(c)
    return apply_norm(params["final_norm"], cfg.norm, x), caches


def run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              remat: bool = False, ops: KernelOps = KERNELS):
    """The training stack: x (B,S,d) -> (final-normed x, the MoE layers'
    summed load-balance loss, float32), the contribution gate first. With
    ``remat`` each repetition of the layer pattern runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, kernels included; the prefix and the
    suffix keep theirs."""
    from torch.utils.checkpoint import checkpoint
    x = _gated(params, cfg, x)
    prefix, pat, n_rep, _ = stack_plan(cfg)
    plan = layer_plan(cfg)
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(x, aux, lo, hi):
        for lp, (kind, ffn) in zip(layers[lo:hi], plan[lo:hi]):
            x, a, _ = apply_layer(lp, cfg, x, kind, ffn, ops=ops)
            if a is not None:
                aux = aux + a
        return x, aux

    lo = len(prefix)
    x, aux = run(x, aux, 0, lo)
    for _ in range(n_rep):
        hi = lo + len(pat)
        x, aux = (checkpoint(run, x, aux, lo, hi, use_reentrant=False,
                             preserve_rng_state=False)
                  if remat else run(x, aux, lo, hi))
        lo = hi
    x, aux = run(x, aux, lo, len(layers))
    return apply_norm(params["final_norm"], cfg.norm, x), aux


def forward(params: Params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            *, dtype=torch.bfloat16, remat: bool = False,
            ops: KernelOps = KERNELS):
    """Training forward: (final hidden states (B,S,d), MoE aux)."""
    x = embed_inputs(params, cfg, inputs, dtype)
    return run_stack(params, cfg, x, remat=remat, ops=ops)


def _chunk_nll(embed_p, cfg: ModelConfig, xc: torch.Tensor, tc: torch.Tensor,
               mc: torch.Tensor):
    """(summed masked NLL, summed mask) of one sequence chunk, float32."""
    logits = unembed(embed_p, xc, tie=cfg.tie_embeddings,
                     cap=cfg.logit_softcap, real_vocab=cfg.vocab_size)
    logz = torch.logsumexp(logits, dim=-1)
    if shd.is_distributed(logits):
        # the target's logit from vocab-sharded logits: a masked sum over
        # the vocab (exact: one term is not zero), which DTensor reduces
        # over "model" where a gather has no sharding rule
        col = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(col == tc[..., None].long(), logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, dtype=torch.bfloat16, remat: bool = False,
            loss_chunk: int = 512, ops: KernelOps = KERNELS):
    """Token cross-entropy of ``batch`` (``tokens``, ``targets`` (B,S),
    optional ``loss_mask``; ``frames`` for the audio stub, ``patches``
    beside the tokens for the vision stub, whose image positions carry no
    target and are dropped), as the reference's: the logits in float32
    over ``loss_chunk``-token pieces of the sequence, each piece
    checkpointed (its (B, chunk, V) logits are recomputed in the backward,
    never held across the loss), plus
    ``aux_loss_coef`` times the MoE load-balance loss. Returns (loss,
    {"ce", "aux"})."""
    from torch.utils.checkpoint import checkpoint
    x, aux = forward(params, cfg, batch, dtype=dtype, remat=remat, ops=ops)
    if cfg.frontend == "vision_stub":
        x = x[:, cfg.num_patches:]
    targets = batch["targets"]
    B, S, _ = x.shape
    mask = batch.get("loss_mask")
    m = (torch.ones((B, S), dtype=torch.float32, device=x.device)
         if mask is None else mask.float())
    chunk = min(loss_chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        nll, n = checkpoint(_chunk_nll, params["embed"], cfg, x[:, i:i + chunk],
                            targets[:, i:i + chunk], m[:, i:i + chunk],
                            use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + nll, cnt + n
    ce = tot / torch.clamp(cnt, min=1.0)
    loss = ce + cfg.moe.aux_loss_coef * aux if cfg.moe is not None else ce
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill / incremental paths
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
            max_len: int, *, dtype=torch.bfloat16, ops: KernelOps = KERNELS):
    """Full-context forward; returns (last-token logits (B,V), caches)."""
    x = embed_inputs(params, cfg, inputs, dtype)
    x, caches = run_prefill_stack(params, cfg, x, max_len=max_len, ops=ops)
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


def decode_step(params: Params, cfg: ModelConfig,
                inputs: Dict[str, torch.Tensor], caches, position, *,
                dtype=torch.bfloat16, ops: KernelOps = KERNELS):
    """One decode step against the contiguous cache: tokens (B,1) ->
    (logits (B,V), caches updated in place). ``position`` is a scalar
    (every row at the same index) or a (B,) vector of per-row indices
    (the engine's slots, ragged prompts in one batch)."""
    x = _gated(params, cfg, embed_inputs(params, cfg, inputs, dtype))

    def layer_fn(lp, kind, ffn, ce, xx):
        return apply_layer_decode(lp, cfg, xx, kind, ffn, ce, position,
                                  ops=ops)

    x, new_caches = _decode_walk(params, cfg, x, caches, layer_fn)
    return _finish_logits(params, cfg, x)[:, 0], new_caches


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
    x = _gated(params, cfg, embed_inputs(params, cfg, inputs, dtype))

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
    x = _gated(params, cfg, embed_inputs(params, cfg, inputs, dtype))

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
    if shd.is_distributed(entry[0]):
        # on a mesh the slot's row, whole, placed as the state but for its
        # batch axis; written back on local blocks
        row = type(entry)(*(shd.rows_like(shd.take_rows(t, [slot]), t)
                            for t in entry))
    else:
        row = type(entry)(*(t[slot:slot + 1] for t in entry))
    if int(pos_start) == 0:
        row = type(entry)(*(torch.zeros_like(t) for t in row))
    out, new = steps(p, cfg, x, row, conv=conv)
    for full, one in zip(entry, new):
        shd.put_rows(full, [slot], shd.full(one))
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
    x = _gated(params, cfg, embed_inputs(params, cfg, inputs, dtype))

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
                shd.put_rows(full, [slot], shd.full(one)[:1])
    return paged_caches


def init_paged_cache(cfg: ModelConfig, slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16, device="cpu",
                     shards: int = 1):
    """Per layer: a page pool of ``num_pages`` pages (plus a sink for each
    of the ``shards`` blocks a mesh cuts the page axis into) for an
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
            dtype, device, shards=shards)
    return [one(kind) for kind, _ in layer_plan(cfg)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu"):
    """Per layer: a contiguous ring of ``max_len`` (a local layer's window)
    for an attention layer, O(1) float32 state for a recurrent or SSM
    layer, ``batch`` rows each."""
    def one(kind):
        if kind == RECURRENT:
            return rglru_mod.init_rglru_state(cfg, batch, device=device)
        if kind == SSM:
            return ssm_mod.init_ssm_state(cfg, batch, device=device)
        return attn_mod.init_kv_cache(
            batch, attn_mod.cache_length(cfg, kind, max_len),
            cfg.num_kv_heads, cfg.resolved_head_dim(), dtype, device)
    return [one(kind) for kind, _ in layer_plan(cfg)]


def _state_axes(kind: LayerKind):
    if kind == RECURRENT:
        return rglru_mod.rglru_state_axes()
    if kind == SSM:
        return ssm_mod.ssm_state_axes()
    raise ValueError(kind)


def cache_axes(cfg: ModelConfig):
    """The logical axes of ``init_cache``'s entries, layer by layer."""
    return [attn_mod.kv_cache_axes() if kind in (ATTN_GLOBAL, ATTN_LOCAL)
            else _state_axes(kind) for kind, _ in layer_plan(cfg)]


def paged_cache_axes(cfg: ModelConfig):
    """The logical axes of ``init_paged_cache``'s entries, layer by
    layer."""
    return [attn_mod.paged_kv_cache_axes()
            if kind in (ATTN_GLOBAL, ATTN_LOCAL) else _state_axes(kind)
            for kind, _ in layer_plan(cfg)]
