"""Qwen3-30B-A3B — 128-expert MoE, top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) vocab=151936; MoE 128 routed experts top-8,
expert hidden 768, no shared experts. Qwen3 uses QK-RMSNorm and no QKV
bias. A copy of the reference's ``configs/qwen3_moe_30b_a3b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,                 # == expert hidden (no dense layers)
        vocab_size=151936,
        layer_pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="silu",
        rope=True,
        rope_theta=1_000_000.0,
        qk_norm=True,
        tie_embeddings=False,
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            d_ff_expert=768,
            num_shared=0,
            aux_loss_coef=0.001,
        ),
        tp_mode="heads",          # 32 heads / 16-way axis
        source="hf:Qwen/Qwen3-30B-A3B",
    )
