"""DeepSeekMoE-16B — fine-grained MoE [arXiv:2401.06066].

28L d_model=2048 16H (kv=16) vocab=102400; 2 shared + 64 routed experts,
top-6, expert hidden 1408 (fine-grained expert segmentation). The first
layer uses a dense FFN (d_ff=10944) as in the released model. A copy of
the reference's ``configs/deepseek_moe_16b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig, register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,               # dense FFN width for the first_k_dense layers
        vocab_size=102400,
        layer_pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="silu",
        rope=True,
        tie_embeddings=False,
        first_k_dense=1,
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_ff_expert=1408,
            num_shared=2,
            d_ff_shared=2816,     # 2 shared experts x 1408
            aux_loss_coef=0.01,
        ),
        tp_mode="heads",
        source="arXiv:2401.06066",
    )
