"""Pipeline parallelism over the 'pod' axis (GPipe schedule, shard_map).

The port of ``repro/parallel/pipeline.py``.  The multi-pod mesh's outer
axis can run as pipeline stages instead of data parallelism: each pod holds
a contiguous slice of layers; microbatches stream through a ``ppermute``
ring between stages.  The schedule is the classic GPipe fill-drain: with S
stages and M microbatches, M + S - 1 ticks, and the bubble fraction is
(S-1)/(M+S-1).  As in the reference every stage runs its layers at every
tick, on zeros before its first microbatch arrives; the last stage's
results reach every stage by a ``psum`` of ``out * is_last``.  Forward
only: the collectives carry no gradient.
"""
from __future__ import annotations

from typing import Callable

import torch

from .spmd import P, axis_index, ppermute, psum, shard_map

__all__ = ["pipeline_apply", "run_pipelined"]


def pipeline_apply(layer_fn: Callable, n_stages: int, microbatches: int,
                   axis: str = "pod"):
    """Build a pipelined stack applier running inside a
    :func:`~.spmd.shard_map` rank manual over ``axis``.

    layer_fn(stage_params, x) -> x applies THIS stage's layer slice.
    Returns fn(stage_params, x_local) where x_local is the full batch
    (replicated over the pipeline axis); the output is the final stage's
    result on every stage.
    """

    def apply(stage_params, x):
        stage = axis_index(axis)
        n = n_stages
        B = x.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} in {microbatches} microbatches")
        mb = B // microbatches
        xs = x.reshape((microbatches, mb) + tuple(x.shape[1:]))
        perm = [(i, (i + 1) % n) for i in range(n)]
        acc = torch.zeros_like(xs)
        inflight = torch.zeros_like(xs[0])
        for t in range(microbatches + n - 1):
            # microbatch t enters stage 0 at tick t
            cur = xs[t if t < microbatches else 0] if stage == 0 \
                else inflight
            out = layer_fn(stage_params, cur)
            # the last stage completes microbatch (t - n + 1) at tick t
            if t >= n - 1:
                acc[t - (n - 1)] = out
            inflight = ppermute(out, axis, perm)
        out = acc.reshape((B,) + tuple(x.shape[1:]))
        is_last = torch.full((), float(stage == n - 1), dtype=out.dtype,
                             device=out.device)
        return psum(out * is_last, axis)

    return apply


def run_pipelined(mesh, layer_fn: Callable, stage_params, x,
                  microbatches: int = 4, axis: str = "pod"):
    """Convenience wrapper: every leaf of ``stage_params`` has a leading
    [n_stages] axis that is split over ``axis``; x is replicated."""
    fn = pipeline_apply(layer_fn, mesh.shape[axis], microbatches, axis)
    sm = shard_map(fn, mesh=mesh, in_specs=(P(axis), P()), out_specs=P())
    return sm(stage_params, x)
