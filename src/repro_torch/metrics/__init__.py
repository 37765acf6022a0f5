from repro_torch.metrics.meters import Meter  # noqa: F401
from repro_torch.metrics.nse import nse  # noqa: F401
