from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused, pack_weights  # noqa: F401
