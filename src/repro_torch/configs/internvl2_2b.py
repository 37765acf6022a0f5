"""InternVL2-2B — VLM: InternViT-300M + InternLM2-1.8B LM [arXiv:2404.16821].

The LM: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The vision
encoder is a stub: each request brings ``num_patches`` precomputed
1024-dim patch embeddings; the model owns the MLP projector (1024 ->
d_model) and the language decoder that reads them. A copy of the
reference's ``configs/internvl2_2b.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        layer_pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="silu",
        rope=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        frontend="vision_stub",
        frontend_dim=1024,        # InternViT feature dim (stub)
        num_patches=256,          # patch tokens per image prepended to text
        tp_mode="heads",
        source="arXiv:2404.16821",
    )
