"""Mamba2-130M — SSD state-space model [arXiv:2405.21060].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads. A copy of the
reference's ``configs/mamba2_130m.py``.
"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        layer_pattern=(SSM,),
        norm="rmsnorm",
        act="silu",
        rope=False,
        tie_embeddings=True,
        ssm=SSMConfig(
            state_dim=128,
            head_dim=64,
            expand=2,
            conv_width=4,
            chunk_size=256,
            ngroups=1,
        ),
        tp_mode="heads",
        source="arXiv:2405.21060",
    )
