"""Step functions, input stand-ins and placements for the launch tooling
(``launch/dryrun.py``): the port of ``repro/launch/steps.py``.

Everything here is mesh-agnostic until ``build_step`` binds a mesh and a
rule table. ``batch_struct`` and ``input_specs`` give ``meta`` tensors
(shape and dtype, no allocation) for every model input; the placement
functions resolve the reference's rules (``distributed/sharding.py``) on
a ``DeviceMesh`` or a ``MeshShape`` stand-in, so they need no devices:

  * ``param_placements`` — the per-layer params (``transformer.param_specs``)
    as ``{'/'-joined path: placements}``;
  * ``opt_placements`` — the optimizer moments as their params, the step
    count whole (the counterpart of ``opt_pspecs``);
  * ``batch_placements`` and ``cache_placements`` (per layer, the
    contiguous cache of ``transformer.cache_axes``).

``build_step(cfg, shape_name, mesh, tc=...)``, the counterpart of
``lower_step``, places a step's inputs on ``mesh`` (every leaf made by
``torch.empty``, under ``FakeTensorMode`` for the dry run)
and returns the step bound to them: the LM training step of
``train.Engine.for_lm`` (with ``tc.fsdp`` the FSDP rule variant places the
params and moments, as the reference's does), a whole prefill
(``transformer.prefill``, or an encoder's forward and logits), or a
decode step on the contiguous cache (``transformer.decode_step``).
``serve_bf16`` holds the serving steps' params as the serving state
does (``transformer.cast_params``: bfloat16, the norm scales and the
leaves read in float32 kept float32); without it they are float32.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (
    INPUT_SHAPES, ModelConfig, ShapeConfig, TrainConfig,
)
from repro_torch.convert import flatten, unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import unembed

Make = Callable[[tuple, torch.dtype], torch.Tensor]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Input stand-ins (meta tensors: no allocation)
# ---------------------------------------------------------------------------
def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 dtype=torch.bfloat16, make: Make = _meta
                 ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        if cfg.family == "audio":
            return {"frames": make((B, S, cfg.frontend_dim), dtype),
                    "targets": make((B, S), i32),
                    "loss_mask": make((B, S), torch.float32)}
        if cfg.family == "vlm":
            T = S - cfg.num_patches
            return {"patches": make((B, cfg.num_patches, cfg.frontend_dim),
                                    dtype),
                    "tokens": make((B, T), i32), "targets": make((B, T), i32)}
        return {"tokens": make((B, S), i32), "targets": make((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"frames": make((B, S, cfg.frontend_dim), dtype)}
        if cfg.family == "vlm":
            return {"patches": make((B, cfg.num_patches, cfg.frontend_dim),
                                    dtype),
                    "tokens": make((B, S - cfg.num_patches), i32)}
        return {"tokens": make((B, S), i32)}
    # decode: one new token against a seq_len cache
    return {"tokens": make((B, 1), i32)}


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """Logical axes per input (resolved to placements by the rules)."""
    if shape.kind == "train":
        if cfg.family == "audio":
            return {"frames": ("batch", "seq", None),
                    "targets": ("batch", "seq"),
                    "loss_mask": ("batch", "seq")}
        if cfg.family == "vlm":
            return {"patches": ("batch", "seq", None),
                    "tokens": ("batch", "seq"),
                    "targets": ("batch", "seq")}
        return {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"frames": ("batch", "seq", None)}
        if cfg.family == "vlm":
            return {"patches": ("batch", "seq", None),
                    "tokens": ("batch", "seq")}
        return {"tokens": ("batch", "seq")}
    return {"tokens": ("batch", None)}


def input_specs(cfg: ModelConfig, shape_name: str,
                make: Make = _meta) -> Dict[str, Any]:
    """All inputs for (cfg, shape): the batch, and for decode the
    contiguous cache of ``seq_len`` and the position (a scalar)."""
    shape = INPUT_SHAPES[shape_name]
    out: Dict[str, Any] = {"batch": batch_struct(cfg, shape, make=make)}
    if shape.kind == "decode":
        out["cache"] = [type(e)(*(make(t.shape, t.dtype) for t in e))
                        for e in tfm.init_cache(cfg, shape.global_batch,
                                                shape.seq_len,
                                                device="meta")]
        out["position"] = make((), torch.int32)
    return out


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def make_train_step_fn(cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                       device="cuda", dtype=torch.bfloat16):
    """``train_step(state, batch) -> (state, metrics)``: the LM engine's
    step (``train.Engine.for_lm``, accumulation over ``tc.grad_accum``
    microbatches, block remat unless ``tc.remat`` is ``"none"``), donated.
    ``train_step.engine`` is the engine."""
    from repro_torch.train import Engine
    eng = Engine.for_lm(cfg, tc, mesh=mesh, device=device, dtype=dtype)

    def train_step(state, batch):
        return eng.step(state, batch)
    train_step.engine = eng
    return train_step


def make_prefill_step_fn(cfg: ModelConfig, max_len: int, *,
                         dtype=torch.bfloat16):
    """A whole prefill (last-token logits and the cache), or for an
    encoder its forward and frame logits."""
    if not cfg.supports_decode():
        def encoder_step(params, batch):
            x, _ = tfm.forward(params, cfg, batch, dtype=dtype)
            return unembed(params["embed"], x, tie=cfg.tie_embeddings,
                           cap=cfg.logit_softcap, real_vocab=cfg.vocab_size)
        return encoder_step

    def prefill_step(params, batch):
        return tfm.prefill(params, cfg, batch, max_len=max_len, dtype=dtype)
    return prefill_step


def make_serve_step_fn(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """One decode step against the contiguous cache."""
    def serve_step(params, cache, batch, position):
        return tfm.decode_step(params, cfg, batch, cache, position,
                               dtype=dtype)
    return serve_step


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
def param_placements(cfg: ModelConfig, mesh, rules) -> Dict[str, tuple]:
    """``{'/'-joined path: placements}`` of the per-layer params."""
    specs = {k: v[1:] for k, v in tfm.flat_param_specs(cfg).items()}
    return {k: shd.resolve(specs[k], shape, mesh, rules)
            for k, shape in param_shapes(cfg).items()}


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """``{'/'-joined path: shape}`` of the per-layer params."""
    return {k: tuple(v.shape) for k, v in flatten(tfm.model_params(
        cfg, lambda shape, *a: torch.empty(shape, device="meta"))).items()}


def opt_placements(placements: Dict[str, tuple], tc: TrainConfig, mesh):
    """The optimizer state's: each moment as its param, the step count
    whole."""
    from repro_torch.optim import OptState
    whole = (shd.Replicate(),) * len(shd.mesh_shape(mesh).shape)
    return OptState(step=whole, mu=placements,
                    nu=placements if tc.optimizer == "adamw" else {})


def batch_placements(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                     structs) -> Dict[str, tuple]:
    axes = batch_axes(cfg, shape)
    return {k: shd.resolve(axes[k], tuple(structs[k].shape), mesh, rules)
            for k in structs}


def cache_placements(cfg: ModelConfig, cache, mesh, rules) -> list:
    """Per layer, the placements of each leaf of the contiguous cache."""
    return [type(e)(*(shd.resolve(a, tuple(t.shape), mesh, rules)
                      for a, t in zip(ax, e)))
            for ax, e in zip(tfm.cache_axes(cfg), cache)]


# ---------------------------------------------------------------------------
# Binding a step to a mesh
# ---------------------------------------------------------------------------
def _place_tree(tree, placements, mesh, device):
    if isinstance(tree, dict):
        return {k: _place_tree(v, placements[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_tree(v, p, mesh, device)
                for v, p in zip(tree, placements)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place_tree(v, p, mesh, device)
                            for v, p in zip(tree, placements)))
    return shd.distribute(tree, mesh, placements, device)


def local_bytes(tree) -> int:
    """Bytes of a tree of (D)Tensors' local blocks on this rank."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = shd.local(tree)
        return t.numel() * t.element_size()
    return 0


def build_step(cfg: ModelConfig, shape_name: str, mesh, *,
               tc: Optional[TrainConfig] = None,
               sequence_parallel: bool = False, serve_bf16: bool = False,
               extra_rules: Optional[dict] = None,
               device=None) -> Tuple[Callable[[], Any], Dict[str, Any], str]:
    """(run, inputs, kind): ``run()`` runs the step once on ``inputs``,
    its placed inputs (``params``, and ``opt`` / ``batch`` / ``cache`` /
    ``position`` as the kind needs). Every full leaf is made by
    ``torch.empty`` (under ``FakeTensorMode`` for the dry run) and placed
    by the rules: each rank keeps its block."""
    shape = INPUT_SHAPES[shape_name]
    tc = tc or TrainConfig(remat="block")
    device = device or mesh.device_type

    def make(s, dt):
        return torch.empty(tuple(s), dtype=dt, device=device)
    rules = shd.make_rules(cfg, mesh=mesh, sequence_parallel=sequence_parallel)
    if extra_rules:
        rules.update(extra_rules)
    ctx = shd.mesh_context(mesh, rules)
    specs = input_specs(cfg, shape_name, make=make)
    batch = _place_tree(specs["batch"], batch_placements(
        cfg, shape, mesh, rules, specs["batch"]), mesh, device)
    like = tfm.model_params(cfg, lambda *a: None)

    if shape.kind == "train":
        from repro_torch.optim import make_optimizer
        from repro_torch.train.state import TrainState
        step = make_train_step_fn(cfg, tc, mesh=mesh, device=device)
        eng = step.engine
        if sequence_parallel or extra_rules:
            eng.rules = rules
            if not tc.fsdp:
                eng.param_rules = rules
        full = {k: make((1,) + v, torch.float32)
                for k, v in param_shapes(cfg).items()}
        opt = make_optimizer(tc)[0](full)
        state = eng._placed(TrainState(
            full, opt, torch.zeros((), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int64)))
        placed = {k: shd.distribute(
            make((1,) + tuple(v.shape), v.dtype), mesh, shd.resolve(
                eng.batch_axes[k], (1,) + tuple(v.shape), mesh, rules),
            device) for k, v in specs["batch"].items()}

        def run():
            return step(state, placed)
        return run, {"params": state.params, "opt": state.opt_state,
                     "batch": placed}, "train"

    dtype = torch.bfloat16 if serve_bf16 else torch.float32
    flat = {k: make(v, dtype if not tfm._keeps_float32(k) else torch.float32)
            for k, v in param_shapes(cfg).items()}
    pl = param_placements(cfg, mesh, rules)
    params = unflatten({k: shd.distribute(v, mesh, pl[k], device)
                        for k, v in flat.items()}, like)
    if shape.kind == "prefill":
        fn = make_prefill_step_fn(cfg, max_len=shape.seq_len)

        def run():
            with ctx, torch.no_grad():
                return fn(params, batch)
        return run, {"params": params, "batch": batch}, "prefill"
    cache = _place_tree(specs["cache"], cache_placements(
        cfg, specs["cache"], mesh, rules), mesh, device)
    position = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                          device=device)
    fn = make_serve_step_fn(cfg)

    def run():
        with ctx, torch.no_grad():
            return fn(params, cache, batch, position)
    return run, {"params": params, "cache": cache, "batch": batch}, "decode"
