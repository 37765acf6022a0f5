"""Paged attention over a KV page pool (kernel + plain version)."""
