"""Config registry. Importing this package registers the Dom-ST variants,
the dense decoders, the mixture-of-experts decoders, the SSM, the RG-LRU
hybrid, the VLM and the audio encoder the port runs: every config of the
reference."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, INPUT_SHAPES, RECURRENT, SSM, DomSTConfig,
    ModelConfig, MoEConfig, PixConConfig, RGLRUConfig, SSMConfig, ShapeConfig,
    TrainConfig, get_config, list_configs, register,
)
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b, domst, gemma2_2b, hubert_xlarge, internvl2_2b,
    llama3_2_3b, mamba2_130m, olmo_1b, qwen2_1_5b, qwen3_moe_30b_a3b,
    recurrentgemma_2b,
)
from repro_torch.configs.smoke import smoke_variant  # noqa: F401

# the ten LM architectures the launch tooling (``launch/dryrun.py``) covers
ASSIGNED_ARCHS = (
    "hubert-xlarge",
    "olmo-1b",
    "internvl2-2b",
    "deepseek-moe-16b",
    "llama3.2-3b",
    "qwen3-moe-30b-a3b",
    "mamba2-130m",
    "recurrentgemma-2b",
    "qwen2-1.5b",
    "gemma2-2b",
)
