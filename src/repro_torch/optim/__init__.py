from repro_torch.optim.optimizer import (  # noqa: F401
    OptState, adamw_init, adamw_update, clip_by_global_norm, make_optimizer,
    sgd_init, sgd_update,
)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
