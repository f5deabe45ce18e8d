"""Parallelism of the port: single-controller ``shard_map`` and its
collectives over a mesh of devices (``spmd``), the logical-axis sharding
rules (``sharding``) and the GPipe schedule (``pipeline``)."""
