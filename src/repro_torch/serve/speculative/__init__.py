from repro_torch.serve.speculative.drafter import (  # noqa: F401
    Drafter, ModelDrafter, NgramDrafter,
)
