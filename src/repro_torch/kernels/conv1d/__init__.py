"""Causal depthwise conv1d with a carried tail (kernel + plain version)."""
