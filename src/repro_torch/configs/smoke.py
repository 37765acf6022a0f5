"""Reduced smoke-test variants: 2 layers, d_model <= 256, vocab <= 512.

A copy of the LM, SSM and RG-LRU branches of the reference's
``configs/smoke.py::smoke_variant``, for the families the port runs. Its
MoE branch waits for that block to be ported, and the Dom-ST branch for a
caller: each raises ``NotImplementedError`` meanwhile.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Shrink ``cfg`` to a CPU-runnable variant of the same family."""
    if cfg.family == "domst":
        raise NotImplementedError("the Dom-ST smoke variant is not ported")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the moe block is not ported yet (ROADMAP Queue A)")

    d_model = min(cfg.d_model, 256)
    # keep head structure: shrink head count but preserve GQA ratio
    if cfg.num_heads:
        n_heads = max(2, min(4, cfg.num_heads))
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        n_kv = max(1, n_heads // ratio)
        head_dim = max(8, d_model // n_heads)
    else:
        n_heads = n_kv = head_dim = 0

    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        window=min(cfg.window, 16),
        first_k_dense=min(cfg.first_k_dense, 1),
        num_patches=min(cfg.num_patches, 8) if cfg.num_patches else 0,
        frontend_dim=min(cfg.frontend_dim, 64) if cfg.frontend_dim else 0,
    )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=32, chunk_size=8)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=d_model)
    # keep the layer pattern (family behaviour) but only 2 layers: take the
    # first 2 kinds, and make hybrids exercise both kinds of layer
    kinds = cfg.layer_kinds()[:2] if cfg.num_layers >= 2 else cfg.layer_pattern
    uniq = tuple(dict.fromkeys(cfg.layer_pattern))
    if len(uniq) > 1:
        kinds = uniq[:2]
    kw["layer_pattern"] = tuple(kinds)
    return cfg.replace(**kw)
