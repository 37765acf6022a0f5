from repro_torch.checkpoint.checkpoint import restore_subtree  # noqa: F401
