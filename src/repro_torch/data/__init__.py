"""Synthetic watershed data and the Dom-ST window pipeline (numpy only)."""
