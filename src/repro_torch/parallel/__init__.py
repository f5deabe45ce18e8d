"""Parallelism helpers of the port (``sharding.padded`` so far)."""
