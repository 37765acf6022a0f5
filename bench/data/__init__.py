"""Frozen copies of the traffic generators the benchmark feeds the port."""
