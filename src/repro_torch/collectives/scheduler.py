"""Step-aligned gradient-bucket scheduler (host-side Symphony counterpart).

The port of ``repro/collectives/scheduler.py``.  The in-network mechanism
(core/symphony.py) aligns ring steps *inside the fabric*; the framework
keeps the sender side aligned by

  1. bucketizing gradients into fixed-size buckets (NCCL-style), so every
     ring step moves a uniform volume (the paper's uniformity assumption,
     §3.2 "Traffic granularity"),
  2. issuing buckets in reverse layer order (grads become ready
     last-layer-first),
  3. shrinking the bucket size when the straggler monitor reports high
     step-time jitter (the chunk-size effect of paper Fig. 8c).

:func:`sync_grads_local` runs INSIDE a
:func:`~repro_torch.parallel.spmd.shard_map` rank that is manual over the
data axes (``runtime/train.py``'s ``grad_sync="ring"``): per-rank partial
gradients exist only there.  Gradients travel in ``flags.RING_SYNC_DTYPE``
(float32 unless ``flags.set_ring_sync_dtype`` names another), read at each
call, as the reference's ``scheduler.py:82`` reads it.

:func:`sync_grads_tp` is the gradient sync of a tensor-parallel rank:
each leaf is the rank's block, summed over ``model`` where the leaf is
replicated there (norm scales, ``wk``/``wv``: each rank's gradient is
its own heads' part) and over the data axes it is not sharded on
(``psum`` for ``grad_sync="xla"``, else the rings of
:func:`sync_grads_local` over the rank's data group).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils import _pytree as pytree

from .. import flags
from ..parallel.sharding import spec_axes
from ..parallel.spmd import axis_size, psum
from .ring import hierarchical_all_reduce, ring_all_reduce_nd

__all__ = ["BucketPlan", "plan_buckets", "sync_grads_local",
           "sync_grads_tp"]


@dataclass(frozen=True)
class BucketPlan:
    bucket_of: tuple[tuple[int, ...], ...]   # leaf indices per bucket
    bucket_bytes: int


def plan_buckets(sizes: list[int], bucket_bytes: int = 32 << 20,
                 dtype_bytes: int = 4) -> BucketPlan:
    """Greedy reverse-order bucketing (grads become ready last-layer-first)."""
    buckets: list[list[int]] = [[]]
    acc = 0
    for i in reversed(range(len(sizes))):
        buckets[-1].append(i)
        acc += sizes[i] * dtype_bytes
        if acc >= bucket_bytes:
            buckets.append([])
            acc = 0
    if not buckets[-1]:
        buckets.pop()
    return BucketPlan(bucket_of=tuple(tuple(b) for b in buckets),
                      bucket_bytes=bucket_bytes)


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def sync_grads_local(grads, axes: tuple[str, ...], *, mode: str = "ring",
                     channels: int = 4, bidirectional: bool = False,
                     bucket_bytes: int = 32 << 20, compress=None,
                     mean: bool = True):
    """All-reduce a tree of gradients (nested dicts, lists, tuples of
    tensors) over the manual mesh ``axes``.

    mode: 'ring' (flat rings over each axis, one after another),
    'hierarchical' (intra-pod ring reduce-scatter + inter-pod ring on the
    shard + intra-pod all-gather), or 'psum' (the group sum in rank order:
    the comparison baseline).  ``mean`` divides by the group's size.

    compress: optional (encode, decode) from optim/compress.py applied
    around the inter-pod hop of hierarchical sync (error-feedback int8).
    ``channels`` and ``bidirectional`` are the reference's arguments:
    hierarchical sync runs ``channels`` inter-pod rings; the flat rings are
    chunked along dim 0 per leaf and take neither, as in the reference.
    """
    leaves, spec = pytree.tree_flatten(grads)
    if not axes:
        return grads
    n_total = math.prod(axis_size(ax) for ax in axes)
    if mode == "psum":
        out = [psum(leaf, axes) for leaf in leaves]
        if mean:
            out = [_div(o, n_total) for o in out]
        return pytree.tree_unflatten(out, spec)
    if mode not in ("ring", "hierarchical"):
        raise ValueError(f"unknown grad-sync mode {mode!r}")
    # Leaf-wise rings chunked along dim 0; buckets still gate issue order.
    plan = plan_buckets([leaf.numel() for leaf in leaves], bucket_bytes)
    out_leaves: list = [None] * len(leaves)
    wire_dtype = flags.ring_sync_dtype()
    for bucket in plan.bucket_of:
        for i in bucket:
            g = leaves[i].to(wire_dtype)
            if mode == "hierarchical" and "pod" in axes and len(axes) == 2:
                inner = axes[1] if axes[0] == "pod" else axes[0]
                red = hierarchical_all_reduce(
                    g.reshape(-1), inner_axis=inner, outer_axis="pod",
                    channels=channels, compress=compress).reshape(g.shape)
            else:
                red = g
                for ax in axes:
                    red = ring_all_reduce_nd(red, ax)
            if mean:
                red = _div(red, n_total)
            out_leaves[i] = red.to(leaves[i].dtype)
    return pytree.tree_unflatten(out_leaves, spec)


def sync_grads_tp(grads: dict, specs: dict, data_axes: tuple[str, ...], *,
                  mode: str = "xla", mean: bool = True, channels: int = 4,
                  bidirectional: bool = False) -> dict:
    """Inside a rank manual over ``model`` and ``data_axes``: every leaf of
    ``grads`` (by parameter name; ``specs`` its PartitionSpec) psummed
    over ``model`` unless it is sharded there, then over the data axes it
    is not sharded on: a psum in rank order (``mode="xla"``, divided by
    the group's size with ``mean``) or :func:`sync_grads_local`'s
    ``"ring"``/``"hierarchical"`` over the rank's data group."""
    out = {}
    for name, g in grads.items():
        if "model" not in spec_axes(specs[name]) and \
                axis_size("model") > 1:
            g = psum(g, "model")
        out[name] = g
    by_axes: dict = {}
    for name in out:
        axes = tuple(a for a in data_axes
                     if a not in spec_axes(specs[name]) and axis_size(a) > 1)
        if axes:
            by_axes.setdefault(axes, []).append(name)
    for axes, names in by_axes.items():
        if mode == "xla":
            n = math.prod(axis_size(a) for a in axes)
            for name in names:
                s = psum(out[name], axes)
                out[name] = _div(s, n) if mean else s
        else:
            synced = sync_grads_local({k: out[k] for k in names}, axes,
                                      mode=mode, channels=channels,
                                      bidirectional=bidirectional, mean=mean)
            out.update(synced)
    return out
