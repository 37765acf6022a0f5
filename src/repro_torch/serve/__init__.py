from repro_torch.serve.forecast import Forecaster  # noqa: F401
