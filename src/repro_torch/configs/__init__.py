"""Config registry. Importing this package registers the Dom-ST variants."""
from repro_torch.configs.base import (  # noqa: F401
    DomSTConfig, ModelConfig, PixConConfig, get_config, list_configs,
    register,
)
from repro_torch.configs import domst  # noqa: F401
