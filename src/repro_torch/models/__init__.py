"""Dense-decoder layers, attention over a paged KV pool, and the stack."""
