from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    restore, restore_lm_params, restore_subtree, save,
)
