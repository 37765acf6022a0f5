"""Config registry. Importing this package registers the Dom-ST variants
and the dense decoders the port runs."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, SSM, DomSTConfig, ModelConfig,
    PixConConfig, get_config, list_configs, register,
)
from repro_torch.configs import domst, qwen2_1_5b  # noqa: F401
from repro_torch.configs.smoke import smoke_variant  # noqa: F401
