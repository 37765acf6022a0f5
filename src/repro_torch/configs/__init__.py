"""Config registry. Importing this package registers the Dom-ST variants,
the dense decoder, the SSM and the RG-LRU hybrid the port runs."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, SSM, DomSTConfig, ModelConfig,
    PixConConfig, RGLRUConfig, SSMConfig, TrainConfig, get_config, list_configs,
    register,
)
from repro_torch.configs import (  # noqa: F401
    domst, mamba2_130m, qwen2_1_5b, recurrentgemma_2b,
)
from repro_torch.configs.smoke import smoke_variant  # noqa: F401
