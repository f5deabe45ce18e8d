"""Single-controller SPMD over a mesh of devices: ``shard_map`` and the
collectives that its per-rank function calls.

The counterpart of the reference's ``compat.shard_map`` / ``axis_size`` /
``manual_axes`` (``repro/compat.py:28-65``) and of the ``jax.lax``
collectives it calls inside (``axis_index``, ``ppermute``, ``psum``,
``pmean``, ``all_to_all``).  As under ``shard_map``, one process drives
every rank:

- the ranks are the coordinates of the *manual* axes (``axis_names``,
  default every axis of the mesh), row-major in the mesh's axis order; an
  axis that is not manual stays whole inside a rank, which runs on the
  device at coordinate 0 of it (GSPMD's partitioning of such an axis has
  no counterpart here);
- :func:`shard_map` splits each global input by its :class:`PartitionSpec`
  onto the ranks' devices, runs ``f`` once per rank, each in its own host
  thread and, on CUDA, on its own stream (kept on the mesh), and assembles
  the outputs by their specs on the mesh's first device; ``P()`` takes the
  first rank's output, as the reference's ``check_vma=False`` does;
- inside ``f``, :func:`ppermute`, :func:`psum`, :func:`pmean` and
  :func:`all_to_all` meet the other ranks at a barrier.  A value crosses
  ranks as a copy onto the receiver's device, enqueued on the receiver's
  stream after it waits on an event recorded on the sender's stream; the
  source is ``record_stream``-ed there so that the caching allocator does
  not hand its memory out again under the copy.  A device may be named
  several times in a mesh: the copy is then a device-to-device copy on
  one card, the stand-in for the wire.
- sums run in rank order on every rank (no float atomics), so every rank
  of a group gets the same bits;
- a rank that raises aborts the barrier, every other rank stops at its
  next collective, and :func:`shard_map` re-raises the first error (a
  barrier that waits :data:`BARRIER_TIMEOUT` seconds breaks too).

Collectives take Python ints for rank indices (:func:`axis_index`), so the
per-rank code keeps the reference's index arithmetic as plain integers.
:func:`ppermute` counts its calls per axis in ``ppermute.counts`` (once
per collective, not per rank): the counterpart of the reference test's
count of ``collective-permute`` ops in the compiled program.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

__all__ = ["PartitionSpec", "P", "shard_map", "rank_devices", "axis_index",
           "axis_size", "manual_axes", "in_rank", "ppermute", "psum",
           "pmean", "all_to_all", "BARRIER_TIMEOUT"]

BARRIER_TIMEOUT = 600.0     # seconds a rank waits for the others


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension: ``None`` (whole), an axis name, or
    a tuple of names (split over their product, the first major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@dataclass
class _Rank:
    group: "_Group"
    rank: int                   # row-major index over the manual axes
    coords: dict                # manual axis -> coordinate
    device: torch.device
    stream: torch.cuda.Stream | None


class _Group:
    """The ranks of one ``shard_map`` call: a barrier and two rounds of
    slots (a rank writes round k's slot only after every rank passed
    round k-1's barrier, so one barrier a collective suffices)."""

    def __init__(self, axes: tuple[str, ...], sizes: dict[str, int]):
        self.axes, self.sizes = axes, sizes
        self.n = math.prod(sizes[a] for a in axes)
        self.barrier = threading.Barrier(self.n, timeout=BARRIER_TIMEOUT)
        self.slots = [[None] * self.n, [None] * self.n]
        self.rounds = [0] * self.n
        self.lock = threading.Lock()
        self.error: BaseException | None = None

    def index(self, coords: dict, axes) -> int:
        """The row-major index of ``coords`` over ``axes``."""
        r = 0
        for a in axes:
            r = r * self.sizes[a] + coords[a]
        return r

    def exchange(self, ctx: _Rank, item) -> list:
        """Post ``item``, wait for every rank, return every rank's item."""
        k = self.rounds[ctx.rank] % 2
        self.rounds[ctx.rank] += 1
        self.slots[k][ctx.rank] = item
        self.barrier.wait()
        return self.slots[k]

    def fail(self, e: BaseException) -> None:
        with self.lock:
            if self.error is None and \
                    not isinstance(e, threading.BrokenBarrierError):
                self.error = e
        self.barrier.abort()


_tls = threading.local()


def _ctx(what: str) -> _Rank:
    ctx = getattr(_tls, "rank", None)
    if ctx is None:
        raise RuntimeError(f"{what} outside a shard_map rank")
    return ctx


def in_rank() -> bool:
    """Whether the caller runs inside a :func:`shard_map` rank."""
    return getattr(_tls, "rank", None) is not None


def manual_axes() -> set[str]:
    """Mesh axes that are manual in the current rank (empty outside)."""
    ctx = getattr(_tls, "rank", None)
    return set() if ctx is None else set(ctx.group.axes)


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis) -> int:
    """The size of a manual axis (or the product over a tuple of them)."""
    g = _ctx("axis_size").group
    return math.prod(g.sizes[a] for a in _axes(axis))


def axis_index(axis) -> int:
    """This rank's coordinate along ``axis`` (row-major over a tuple)."""
    ctx = _ctx("axis_index")
    return ctx.group.index(ctx.coords, _axes(axis))


def _members(ctx: _Rank, axes: tuple[str, ...]) -> list[int]:
    """The ranks of this rank's group along ``axes``, by their index along
    ``axes``: the same list on every member."""
    g = ctx.group
    out = []
    for pos in itertools.product(*(range(g.sizes[a]) for a in axes)):
        c = dict(ctx.coords)
        c.update(zip(axes, pos))
        out.append(g.index(c, g.axes))
    return out


def _post(x: torch.Tensor):
    """``x`` with an event recorded after the work that produces it.  A
    copy between ranks carries no gradient, so a tensor that autograd
    tracks is refused."""
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "collectives of the port carry no gradient: detach, or run "
            "under torch.no_grad()")
    if not x.is_cuda:
        return x, None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return x, ev


def _fetch(item, dev: torch.device) -> torch.Tensor:
    """A copy of a posted tensor on ``dev``, on its current stream."""
    x, ev = item
    if ev is not None:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).wait_event(ev)
        else:
            ev.synchronize()
    y = torch.empty_like(x, device=dev)
    y.copy_(x, non_blocking=dev.type == "cuda")
    if x.is_cuda and dev.type == "cuda":
        x.record_stream(torch.cuda.current_stream(dev))
    return y


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) pairs of
    indices along ``axis``; a rank that no pair names as destination gets
    zeros."""
    ctx = _ctx("ppermute")
    axes = _axes(axis)
    if ctx.rank == 0:
        ppermute.counts[axis] += 1
    slots = ctx.group.exchange(ctx, _post(x))
    me = axis_index(axes)
    src = [s for s, d in perm if d == me]
    if not src:
        return torch.zeros_like(x)
    return _fetch(slots[_members(ctx, axes)[src[0]]], ctx.device)


ppermute.counts = Counter()


def psum(x, axis):
    """Sum over the ranks of ``axis`` (a name or a tuple), added in rank
    order on every rank.  A Python number gives number x group size."""
    ctx = _ctx("psum")
    axes = _axes(axis)
    if not isinstance(x, torch.Tensor):
        return x * axis_size(axes)
    slots = ctx.group.exchange(ctx, _post(x))
    acc = None
    for r in _members(ctx, axes):
        y = x if r == ctx.rank else _fetch(slots[r], ctx.device)
        acc = y if acc is None else acc + y
    return acc


def pmean(x, axis):
    """:func:`psum` divided by the group's size (a tensor divisor: torch's
    CUDA kernel divides by a Python scalar as a multiplication by its
    reciprocal)."""
    s = psum(x, axis)
    n = axis_size(axis)
    if not isinstance(s, torch.Tensor):
        return s / n
    return s / torch.full((), n, dtype=s.dtype, device=s.device)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: chunk j of ``split_axis`` goes to rank j of
    ``axis``; the chunks received from ranks 0..n-1 are stacked at
    ``concat_axis`` (``tiled=False``: ``split_axis`` has size n and is
    removed) or concatenated along it (``tiled=True``)."""
    ctx = _ctx("all_to_all")
    axes = _axes(axis)
    n = axis_size(axes)
    if x.shape[split_axis] % n or (not tiled and x.shape[split_axis] != n):
        raise ValueError(f"all_to_all: split axis of size "
                         f"{x.shape[split_axis]} over {n} ranks")
    slots = ctx.group.exchange(ctx, _post(x))
    me, c = axis_index(axes), x.shape[split_axis] // n
    parts = []
    for r in _members(ctx, axes):
        y, ev = (x, None) if r == ctx.rank else slots[r]
        piece = y.narrow(split_axis, me * c, c)
        parts.append(piece.clone() if r == ctx.rank
                     else _fetch((piece, ev), ctx.device))
    if tiled:
        return torch.cat(parts, dim=concat_axis)
    return torch.stack([p.squeeze(split_axis) for p in parts],
                       dim=concat_axis)


# ------------------------------------------------------------- shard_map

def _map_spec(fn, spec, x):
    """Apply ``fn(leaf, spec)`` to every leaf of ``x``; ``spec`` is a tree
    of :class:`PartitionSpec` matching a prefix of ``x``'s."""
    if spec is None or isinstance(spec, PartitionSpec):
        return _map_leaves(lambda leaf: fn(leaf, spec or P()), x)
    if isinstance(spec, dict):
        if set(spec) != set(x):
            raise ValueError(f"spec keys {sorted(spec)} against "
                             f"{sorted(x)}")
        return {k: _map_spec(fn, spec[k], x[k]) for k in x}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(x):
            raise ValueError(f"{len(spec)} specs for {len(x)} values")
        out = [_map_spec(fn, s, v) for s, v in zip(spec, x)]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    raise TypeError(f"not a spec: {spec!r}")


def _map_leaves(fn, x):
    if isinstance(x, dict):
        return {k: _map_leaves(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        out = [_map_leaves(fn, v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    return fn(x)


def _dim_axes(spec: PartitionSpec, ndim: int, manual) -> list[tuple]:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} for a tensor of {ndim} dimensions")
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        axes = () if e is None else _axes(e)
        for a in axes:
            if a not in manual:
                raise ValueError(f"spec {spec} names {a!r}, which is not a "
                                 f"manual axis ({sorted(manual)})")
        out.append(axes)
    return out


def _split(x, spec: PartitionSpec, ctx: _Rank):
    """Rank ``ctx``'s block of a global input, on its device."""
    if not isinstance(x, torch.Tensor):
        if spec:
            raise ValueError(f"spec {spec} for a non-tensor {type(x)}")
        return x
    g = ctx.group
    for d, axes in enumerate(_dim_axes(spec, x.ndim, g.axes)):
        if not axes:
            continue
        n = math.prod(g.sizes[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split over {axes} ({n} ranks)")
        k = x.shape[d] // n
        x = x.narrow(d, g.index(ctx.coords, axes) * k, k)
    if x.is_cuda and ctx.stream is not None and x.device == ctx.device:
        x.record_stream(ctx.stream)
    return x.to(ctx.device, non_blocking=True)


def _assemble(outs: list, spec: PartitionSpec, group: _Group, ranks: list,
              dev: torch.device):
    """One global output from the ranks' blocks ``outs``."""
    first = outs[0]
    if not isinstance(first, torch.Tensor) or not spec:
        return first
    dims = _dim_axes(spec, first.ndim, group.axes)
    named = {a for axes in dims for a in axes}
    shape = [s * math.prod(group.sizes[a] for a in axes)
             for s, axes in zip(first.shape, dims)]
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    for piece, ctx in zip(outs, ranks):
        if any(ctx.coords[a] for a in group.axes if a not in named):
            continue                # a replica of another rank's block
        view = out
        for d, axes in enumerate(dims):
            if axes:
                view = view.narrow(d, group.index(ctx.coords, axes)
                                   * piece.shape[d], piece.shape[d])
        view.copy_(piece)
    return out


def _leaves(x) -> list:
    out: list = []
    _map_leaves(out.append, x)
    return out


def rank_devices(mesh, axis_names=None) -> list[torch.device]:
    """The device of each rank of :func:`shard_map` over ``mesh``'s manual
    ``axis_names`` (default all), in rank order: coordinate 0 of every
    other axis."""
    manual = [a for a in mesh.axis_names
              if axis_names is None or a in set(axis_names)]
    out = []
    for pos in itertools.product(*(range(mesh.shape[a]) for a in manual)):
        coords = dict(zip(manual, pos))
        out.append(mesh.devices[tuple(coords.get(a, 0)
                                      for a in mesh.axis_names)])
    return out


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    """``f`` run once per rank of ``mesh``'s manual axes (``axis_names``,
    default all), each rank on its block of every input, from its own
    host thread and CUDA stream; returns the outputs assembled by
    ``out_specs`` on the mesh's first device."""
    manual = tuple(a for a in mesh.axis_names
                   if axis_names is None or a in set(axis_names))
    sizes = mesh.shape

    def run(*args):
        if in_rank():
            raise RuntimeError("shard_map inside a shard_map rank")
        group = _Group(manual, sizes)
        ranks = []
        for pos, dev in zip(
                itertools.product(*(range(sizes[a]) for a in manual)),
                rank_devices(mesh, manual)):
            coords = dict(zip(manual, pos))
            stream = None
            if dev.type == "cuda":
                key = (len(ranks), dev)
                stream = mesh.streams.get(key)
                if stream is None:
                    stream = mesh.streams[key] = torch.cuda.Stream(dev)
            ranks.append(_Rank(group, len(ranks), coords, dev, stream))
        callers = {c.device: torch.cuda.current_stream(c.device)
                   for c in ranks if c.stream is not None}
        grad = torch.is_grad_enabled()

        def one(ctx: _Rank):
            _tls.rank = ctx
            try:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(torch.set_grad_enabled(grad))
                    if ctx.stream is not None:
                        stack.enter_context(torch.cuda.device(ctx.device))
                        stack.enter_context(torch.cuda.stream(ctx.stream))
                        ctx.stream.wait_stream(callers[ctx.device])
                    local = _map_spec(lambda x, s: _split(x, s, ctx),
                                      in_specs, args)
                    return f(*local)
            except BaseException as e:
                group.fail(e)
                raise
            finally:
                _tls.rank = None

        with ThreadPoolExecutor(len(ranks)) as pool:
            futs = [pool.submit(one, c) for c in ranks]
            errs = [fu.exception() for fu in futs]
        if group.error is not None:
            raise group.error
        if any(e is not None for e in errs):
            raise RuntimeError("a shard_map rank's barrier broke (timeout "
                               f"of {BARRIER_TIMEOUT} s?)") from next(
                                   e for e in errs if e is not None)
        outs = [fu.result() for fu in futs]
        for c, o in zip(ranks, outs):
            if c.stream is None:
                continue
            caller = callers[c.device]
            caller.wait_stream(c.stream)
            for leaf in _leaves(o):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(caller)
        dev = mesh.devices.flat[0]
        per_leaf = [_leaves(o) for o in outs]
        spec_leaves = []
        _map_spec(lambda leaf, s: spec_leaves.append(s), out_specs, outs[0])
        flat = [_assemble([pl[i] for pl in per_leaf], spec_leaves[i], group,
                          ranks, dev) for i in range(len(spec_leaves))]
        it = iter(flat)
        return _map_leaves(lambda _: next(it), outs[0])

    return run

