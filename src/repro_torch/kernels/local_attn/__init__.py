"""Sliding-window attention over a whole prompt (kernel + plain version)."""
