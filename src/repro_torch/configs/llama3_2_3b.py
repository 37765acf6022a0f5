"""Llama-3.2-3B — small llama3 dense decoder [hf:meta-llama/Llama-3.2-1B family].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, rope theta
500,000. A copy of the reference's ``configs/llama3_2_3b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("llama3.2-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        layer_pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="silu",
        rope=True,
        rope_theta=500_000.0,
        tie_embeddings=True,
        tp_mode="ffn",
        source="hf:meta-llama/Llama-3.2-3B",
    )
