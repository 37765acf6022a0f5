from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    restore, restore_subtree, save,
)
