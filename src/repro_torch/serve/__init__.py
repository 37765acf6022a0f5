from repro_torch.serve.engine import InferenceEngine  # noqa: F401
from repro_torch.serve.forecast import Forecaster  # noqa: F401
from repro_torch.serve.sampling import SamplingParams, stream_digest  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    PagePool, Request, Scheduler,
)
from repro_torch.serve.speculative import (  # noqa: F401
    Drafter, ModelDrafter, NgramDrafter,
)
from repro_torch.serve.state import (  # noqa: F401
    InferenceState, new_paged_inference_state,
)
