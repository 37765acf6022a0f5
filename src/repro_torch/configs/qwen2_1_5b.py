"""Qwen2-1.5B — dense GQA decoder with QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. A copy of the
reference's ``configs/qwen2_1_5b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("qwen2-1.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        layer_pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="silu",
        qkv_bias=True,
        rope=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        tp_mode="ffn",
        source="arXiv:2407.10671",
    )
