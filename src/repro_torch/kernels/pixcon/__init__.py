from repro_torch.kernels.pixcon.ops import pixcon_gate  # noqa: F401
