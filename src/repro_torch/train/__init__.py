from repro_torch.train.engine import Engine, accumulate_grads  # noqa: F401
from repro_torch.train.state import TrainState, new_train_state  # noqa: F401
