"""Explicit ring collectives and the gradient-bucket scheduler of the
port, run inside :func:`repro_torch.parallel.spmd.shard_map` ranks."""
from .ring import (hierarchical_all_reduce, ring_all_gather, ring_all_reduce,
                   ring_all_reduce_nd, ring_reduce_scatter)
from .scheduler import BucketPlan, plan_buckets, sync_grads_local

__all__ = ["BucketPlan", "hierarchical_all_reduce", "plan_buckets",
           "ring_all_gather", "ring_all_reduce", "ring_all_reduce_nd",
           "ring_reduce_scatter", "sync_grads_local"]
