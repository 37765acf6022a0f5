"""OLMo-1B — dense decoder with non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304. A copy of the
reference's ``configs/olmo_1b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("olmo-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        layer_pattern=(ATTN_GLOBAL,),
        norm="nonparam_ln",       # OLMo: LayerNorm without learnable affine
        act="silu",
        rope=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        tp_mode="heads",
        source="arXiv:2402.00838",
    )
