from repro_torch.metrics.nse import nse  # noqa: F401
