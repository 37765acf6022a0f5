"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention 2:1 [arXiv:2402.19427].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.
Layer pattern (recurrent, recurrent, local) repeating. A copy of the
reference's ``configs/recurrentgemma_2b.py``.
"""
from repro_torch.configs.base import (
    ATTN_LOCAL, RECURRENT, ModelConfig, RGLRUConfig, register,
)


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        layer_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
        window=2048,
        norm="rmsnorm",
        act="gelu",               # gated-GELU MLP
        rope=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        embed_scale=True,
        rglru=RGLRUConfig(lru_width=2560, conv_width=4),
        tp_mode="ffn",
        source="arXiv:2402.19427",
    )
