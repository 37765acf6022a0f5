"""Mamba-2 SSD intra-chunk dual form (kernel + plain version)."""
