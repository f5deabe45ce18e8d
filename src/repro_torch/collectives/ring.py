"""Explicit ring collectives built from ``ppermute`` (inside ``shard_map``).

The port of ``repro/collectives/ring.py``.  These make the 2(N-1)-step
structure that Symphony aligns visible: every step is one
:func:`~repro_torch.parallel.spmd.ppermute` to the ring successor (a copy
onto its device, on its stream), counted in ``ppermute.counts``.  The
trainer's ``grad_sync="ring"`` synchronizes gradients with these.

All functions run inside a :func:`~repro_torch.parallel.spmd.shard_map`
rank and operate on the *local shard* of each rank.  Conventions:

  ring_reduce_scatter(x, axis) : x local [n*k, ...] -> [k, ...] reduced shard
  ring_all_gather(x, axis)     : x local [k, ...]   -> [n*k, ...]
  ring_all_reduce(x, axis)     : x local [...]      -> [...] sum over axis

Multi-channel: ``channels=c`` splits the tensor into c interleaved chunks
and runs c rings one after another (NCCL channel semantics: the "multiple
parallel 1-D rings" of paper Fig. 1a).  Bidirectional rings split each
chunk in half and run the two directions.

The per-rank code is the reference's: the same chunk indices, the same
order of adds (the local chunk plus what arrived), ``n - 1`` steps a phase
and the all-gather's placement by source shard, so in float32 a ring gives
the reference's bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.spmd import axis_index, axis_size, ppermute

__all__ = ["ring_reduce_scatter", "ring_all_gather", "ring_all_reduce",
           "ring_all_reduce_nd", "hierarchical_all_reduce"]


def _perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def ring_reduce_scatter(x: torch.Tensor, axis: str, reverse: bool = False
                        ) -> torch.Tensor:
    """x: [n*k, ...] local -> [k, ...]: this rank's shard of the sum.

    Step s: each rank sends its running partial to the successor and adds
    the local chunk for the shard now being accumulated.  n-1 steps, each
    moving k elements: bandwidth-optimal.
    """
    n = axis_size(axis)
    if n == 1:
        return x
    idx = axis_index(axis)
    k = x.shape[0] // n
    chunks = x.reshape((n, k) + tuple(x.shape[1:]))
    sgn = -1 if reverse else 1
    perm = _perm(n, sgn)
    acc = chunks[(idx - sgn) % n]
    for s in range(1, n):
        acc = chunks[(idx - sgn * (s + 1)) % n] + ppermute(acc, axis, perm)
    return acc


def ring_all_gather(x: torch.Tensor, axis: str, reverse: bool = False
                    ) -> torch.Tensor:
    """x: [k, ...] local shard -> [n*k, ...] full, ring-pipelined."""
    n = axis_size(axis)
    if n == 1:
        return x
    idx = axis_index(axis)
    sgn = -1 if reverse else 1
    perm = _perm(n, sgn)
    pieces = [x]
    cur = x
    for _ in range(n - 1):
        cur = ppermute(cur, axis, perm)
        pieces.append(cur)
    # rank idx holds shards [idx, idx-sgn, idx-2sgn, ...]: place each at its
    # source shard's position
    out = x.new_empty((n,) + tuple(x.shape))
    for j, piece in enumerate(pieces):
        out[(idx - sgn * j) % n] = piece
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def ring_all_reduce(x: torch.Tensor, axis: str, channels: int = 1,
                    bidirectional: bool = False) -> torch.Tensor:
    """Flat ring all-reduce = reduce-scatter + all-gather, 2(N-1) steps.

    channels > 1 splits into parallel rings (NCCL channels); bidirectional
    runs half the data around each ring direction.
    """
    n = axis_size(axis)
    if n == 1:
        return x
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % (n * channels * (2 if bidirectional else 1))
    if pad:
        flat = F.pad(flat, (0, pad))
    parts = flat.reshape(channels * (2 if bidirectional else 1), -1)
    outs = []
    for c in range(parts.shape[0]):
        rev = bidirectional and (c % 2 == 1)
        outs.append(ring_all_gather(ring_reduce_scatter(parts[c], axis, rev),
                                    axis, rev))
    out = torch.stack(outs).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def ring_all_reduce_nd(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Ring all-reduce chunking along dim 0 WITHOUT flattening: the
    reference keeps trailing dims' (auto/TP) sharding this way, so the
    permute payload stays the local shard."""
    n = axis_size(axis)
    if n == 1:
        return x
    orig = x.shape
    if x.ndim == 0:
        x = x.reshape(1)
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    out = ring_all_gather(ring_reduce_scatter(x, axis), axis)
    if pad:
        out = out[:-pad]
    return out.reshape(orig)


def hierarchical_all_reduce(x: torch.Tensor, inner_axis: str,
                            outer_axis: str, channels: int = 1,
                            compress=None) -> torch.Tensor:
    """Multi-pod gradient sync: ring reduce-scatter intra-pod, ring
    all-reduce of the shard across pods (the DCN hop, the tier the paper's
    fabric represents), then ring all-gather intra-pod.

    Wire cost per chip: 2S(n-1)/n intra + 2S'(p-1)/p inter with S' = S/n:
    the inter-pod traffic is 1/n of a naive flat all-reduce across all
    chips.  ``compress`` = (encode, decode) pair applied around the
    inter-pod hop (e.g. int8 error-feedback, optim/compress.py).
    """
    n = axis_size(inner_axis)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % (n * channels)
    if pad:
        flat = F.pad(flat, (0, pad))
    shard = ring_reduce_scatter(flat, inner_axis)
    if compress is not None:
        encode, decode = compress
        shard_q, meta = encode(shard)
        shard_q = ring_all_reduce(shard_q, outer_axis, channels=channels)
        shard = decode(shard_q, meta)
    else:
        shard = ring_all_reduce(shard, outer_axis, channels=channels)
    out = ring_all_gather(shard, inner_axis)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)
