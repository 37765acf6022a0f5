"""Gemma2-2B — local/global alternating attention + logit softcaps [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, window 4096,
attention softcap 50, final-logit softcap 30, pre+post sandwich norms,
sqrt(d_model) embedding scaling. ``gemma2-2b-localonly`` switches the
global layers to window-4096 sliding attention, the reference's variant
for its longest context (not the published config). A copy of the
reference's ``configs/gemma2_2b.py``.
"""
from repro_torch.configs.base import (
    ATTN_GLOBAL, ATTN_LOCAL, ModelConfig, register,
)


@register("gemma2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
        window=4096,
        norm="rmsnorm",
        act="gelu",
        rope=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        embed_scale=True,
        logit_softcap=30.0,
        attn_softcap=50.0,
        post_norms=True,
        tp_mode="ffn",
        source="arXiv:2408.00118",
    )


@register("gemma2-2b-localonly")
def config_local_only() -> ModelConfig:
    """Sliding-window-only variant for the long_500k shape (sub-quadratic)."""
    return config().replace(
        name="gemma2-2b-localonly",
        layer_pattern=(ATTN_LOCAL,),
        notes="long-context variant: all layers local window=4096",
    )
