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
  onto the ranks' devices, runs ``f`` once per rank, each in the host
  thread and, on CUDA, on the stream of its rank index (both kept for
  the life of the process, so that PyTorch's cuBLAS workspaces, one a
  thread's handle and stream, do not multiply), and assembles
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
count of ``collective-permute`` ops in the compiled program.  Every
collective is also counted in :data:`TALLY` by kind, axes, group size and
operand bytes (what the dry-run turns into wire bytes).

**Gradients: one graph, one backward.**  The copy that carries a value
across ranks is a differentiable copy (whose backward copies the
gradient back: :class:`_Copy` says why), so :func:`psum`,
:func:`all_gather` and :func:`psum_scatter` (and the other collectives)
are autograd ops over copies of the other ranks' tensors, and the ranks'
forwards form *one* autograd graph.  The controller, after
:func:`shard_map` returns, runs one backward from a single global value
(rank 0's copy of the loss, which depends on every rank through the
loss's psums); autograd then does the transposes through the copies
(all-reduce <-> identity, all-gather <-> reduce-scatter), and no
collective runs in a backward.  None may: the backward of CUDA tensors
runs on the device's single autograd thread, where no rank is set, and a
barrier there would wait for ranks that cannot run, so a collective
called inside a backward raises ``RuntimeError``.  In the forward, a
collective whose result takes gradients also counts its transpose in
:data:`TALLY` (the backward's collective in a partitioned program).

Parameters do not change within a step, so a rank may read another rank's
parameter shard without meeting it: :func:`peers` exchanges references to
them once (a barrier in the forward), and :func:`gather_static` (FSDP's
parameter all-gather) concatenates copies of them with no barrier, also
in a remat recompute inside the backward.

**Lone-rank mode** (:func:`lone_rank`): one rank of a mesh runs alone, in
the caller's thread (the dry-run's partitioned program on meta tensors, or
one rank's program on the card).  Every collective then returns a tensor
of the right shape as if every rank held this rank's value (psum: a copy
of its input; all_gather: the input repeated; psum_scatter: this rank's
slice; ppermute: the input) and is counted in :data:`TALLY`.
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
           "axis_size", "manual_axes", "in_rank", "rank_index", "ppermute",
           "psum", "pmean", "pmax", "all_gather", "psum_scatter",
           "all_to_all", "peers", "gather_static", "lone_rank", "Tally",
           "TALLY", "BARRIER_TIMEOUT", "rank_streams"]

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


class Tally:
    """Collectives by (kind, axes, group size): ``count`` and operand
    ``bytes`` (an all-gather's gathered result, a reduce-scatter's whole
    input), each collective once (rank 0 counts in a real group).  Kinds
    are the reference's HLO names: ``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.count: Counter = Counter()
        self.bytes: Counter = Counter()

    def clear(self) -> None:
        with self.lock:
            self.count.clear()
            self.bytes.clear()

    def add(self, kind: str, axes: tuple, n: int, nbytes: int) -> None:
        with self.lock:
            self.count[(kind, axes, n)] += 1
            self.bytes[(kind, axes, n)] += int(nbytes)

    def by_kind(self) -> dict[str, int]:
        out: Counter = Counter()
        for (kind, _, _), c in self.count.items():
            out[kind] += c
        return dict(out)


TALLY = Tally()
# the transpose a collective's backward performs
_TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
              "reduce-scatter": "all-gather", "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


class _Group:
    """The ranks of one ``shard_map`` call: a barrier and two rounds of
    slots (a rank writes round k's slot only after every rank passed
    round k-1's barrier, so one barrier a collective suffices).  A lone
    group (:func:`lone_rank`) has one thread and no barrier."""

    def __init__(self, axes: tuple[str, ...], sizes: dict[str, int],
                 lone: bool = False):
        self.axes, self.sizes, self.lone = axes, sizes, lone
        self.n = math.prod(sizes[a] for a in axes)
        self.barrier = threading.Barrier(1 if lone else self.n,
                                         timeout=BARRIER_TIMEOUT)
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


def rank_index() -> int:
    """This rank's row-major index over the manual axes."""
    return _ctx("rank_index").rank


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


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _collective(what: str) -> _Rank:
    """The calling rank, refusing a collective inside a backward (see the
    module docstring)."""
    ctx = _ctx(what)
    if _in_backward():
        raise RuntimeError(
            f"{what} inside an autograd backward: a collective's transpose "
            "is taken through the forward's copies (spmd module docstring)")
    return ctx


def _count(ctx: _Rank, kind: str, axes: tuple, nbytes: int,
           out=None) -> None:
    """Count a collective (rank 0 of a real group; a lone rank always) and,
    when ``out`` takes gradients, its transpose in the backward."""
    n = math.prod(ctx.group.sizes[a] for a in axes)
    if n <= 1 or (ctx.rank != 0 and not ctx.group.lone):
        return
    TALLY.add(kind, axes, n, nbytes)
    if isinstance(out, torch.Tensor) and out.requires_grad:
        TALLY.add(_TRANSPOSE[kind], axes, n, nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _post(x: torch.Tensor):
    """``x`` with an event recorded after the work that produces it."""
    if not x.is_cuda:
        return x, None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return x, ev


class _Copy(torch.autograd.Function):
    """``x.to(dev, copy=True)`` whose backward hands the sender a copy of
    the gradient, never the gradient itself.

    Autograd passes one gradient tensor unchanged to every input of a sum
    and through a copy on one device, and adds a later gradient into an
    earlier one in place once no other reference holds it.  Through a
    plain copy a psum's gradient reached every sender as one tensor, on
    each sender's stream; a sender whose tensor took a second gradient
    (each rank's MoE aux loss from the two data ranks' psums, each MLA
    rank's q sum of squares from its model group's) added it into that
    shared tensor in place on its stream, overtaking another sender's
    queued read of it on another stream, which then read the sum: a
    gradient counted twice, now and then, as the card's timing fell.  A
    copy of its own per sender keeps every in-place add on the stream
    that alone reads the tensor."""

    @staticmethod
    def forward(ctx, x, dev):
        ctx.src = x.device
        return x.to(dev, copy=True, non_blocking=dev.type == "cuda")

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.src, copy=True), None


def _fetch(item, dev: torch.device) -> torch.Tensor:
    """A copy of a posted tensor on ``dev``, on its current stream: an
    autograd op, whose backward carries a copy of the gradient back to the
    sender's tensor (:class:`_Copy`)."""
    x, ev = item
    if ev is not None:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).wait_event(ev)
        else:
            ev.synchronize()
    y = _Copy.apply(x, dev)
    if x.is_cuda and dev.type == "cuda":
        x.record_stream(torch.cuda.current_stream(dev))
    return y


def _slots(ctx: _Rank, x: torch.Tensor) -> list:
    """Every rank's posted ``x``; a lone rank stands for each of them."""
    if ctx.group.lone:
        return [(x, None)] * ctx.group.n
    return ctx.group.exchange(ctx, _post(x))


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) pairs of
    indices along ``axis``; a rank that no pair names as destination gets
    zeros."""
    ctx = _collective("ppermute")
    axes = _axes(axis)
    if ctx.rank == 0 or ctx.group.lone:
        ppermute.counts[axis] += 1
    slots = _slots(ctx, x)
    me = axis_index(axes)
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(x) if not src else (
        x.clone() if ctx.group.lone else
        _fetch(slots[_members(ctx, axes)[src[0]]], ctx.device))
    _count(ctx, "collective-permute", axes, _nbytes(x), out)
    return out


ppermute.counts = Counter()


def psum(x, axis):
    """Sum over the ranks of ``axis`` (a name or a tuple), added in rank
    order on every rank.  A Python number gives number x group size."""
    ctx = _collective("psum")
    axes = _axes(axis)
    if not isinstance(x, torch.Tensor):
        return x * axis_size(axes)
    acc = _fold(ctx, x, axes, torch.add)
    _count(ctx, "all-reduce", axes, _nbytes(x), acc)
    return acc


def _fold(ctx: _Rank, x: torch.Tensor, axes: tuple, op) -> torch.Tensor:
    """``op`` over the group's values along ``axes`` in rank order (a lone
    rank: a copy of its own)."""
    if ctx.group.lone:
        return x.clone()
    slots = _slots(ctx, x)
    acc = None
    for r in _members(ctx, axes):
        y = x if r == ctx.rank else _fetch(slots[r], ctx.device)
        acc = y if acc is None else op(acc, y)
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


@torch.no_grad()
def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise maximum over the ranks of ``axis`` (no gradient)."""
    ctx = _collective("pmax")
    axes = _axes(axis)
    acc = _fold(ctx, x, axes, torch.maximum)
    _count(ctx, "all-reduce", axes, _nbytes(x))
    return acc


def all_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``axis`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    ctx = _collective("all_gather")
    axes = _axes(axis)
    if ctx.group.lone:
        out = torch.cat([x] * axis_size(axes), dim=dim)
    else:
        slots = _slots(ctx, x)
        out = torch.cat([x if r == ctx.rank else _fetch(slots[r], ctx.device)
                         for r in _members(ctx, axes)], dim=dim)
    _count(ctx, "all-gather", axes, _nbytes(out), out)
    return out


def psum_scatter(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Block i (along ``dim``, of ``axis``'s size) of the sum over the ranks
    of ``axis`` on the rank of index i, added in rank order
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    ctx = _collective("psum_scatter")
    axes = _axes(axis)
    n = axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size "
                         f"{x.shape[dim]} over {n} ranks")
    c = x.shape[dim] // n
    me = axis_index(axes)
    if ctx.group.lone:
        acc = x.narrow(dim, me * c, c).clone()
    else:
        slots = _slots(ctx, x)
        acc = None
        for r in _members(ctx, axes):
            if r == ctx.rank:
                y = x.narrow(dim, me * c, c)
            else:
                y, ev = slots[r]
                y = _fetch((y.narrow(dim, me * c, c), ev), ctx.device)
            acc = y if acc is None else acc + y
        acc = acc.contiguous()
    _count(ctx, "reduce-scatter", axes, _nbytes(x), acc)
    return acc


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: chunk j of ``split_axis`` goes to rank j of
    ``axis``; the chunks received from ranks 0..n-1 are stacked at
    ``concat_axis`` (``tiled=False``: ``split_axis`` has size n and is
    removed) or concatenated along it (``tiled=True``)."""
    ctx = _collective("all_to_all")
    axes = _axes(axis)
    n = axis_size(axes)
    if x.shape[split_axis] % n or (not tiled and x.shape[split_axis] != n):
        raise ValueError(f"all_to_all: split axis of size "
                         f"{x.shape[split_axis]} over {n} ranks")
    slots = _slots(ctx, x)
    me, c = axis_index(axes), x.shape[split_axis] // n
    parts = []
    for r in [ctx.rank] * n if ctx.group.lone else _members(ctx, axes):
        y, ev = (x, None) if r == ctx.rank else slots[r]
        piece = y.narrow(split_axis, me * c, c)
        parts.append(piece.clone() if r == ctx.rank
                     else _fetch((piece, ev), ctx.device))
    if tiled:
        out = torch.cat(parts, dim=concat_axis)
    else:
        out = torch.stack([p.squeeze(split_axis) for p in parts],
                          dim=concat_axis)
    _count(ctx, "all-to-all", axes, _nbytes(x), out)
    return out


# ---------------------------------------------- parameters of other ranks

@dataclass
class Peers:
    """What the ranks of one group along ``axes`` posted to :func:`peers`,
    in their index order; ``counts`` says whether gathers of them are
    counted in :data:`TALLY` (rank 0, or a lone rank)."""
    items: list
    axes: tuple[str, ...]
    counts: bool


def peers(obj, axis) -> Peers:
    """Exchange ``obj`` (references to parameters) with the ranks of this
    rank's group along ``axis``: a barrier in the forward, nothing copied.
    A lone rank stands for every member."""
    ctx = _collective("peers")
    axes = _axes(axis)
    if ctx.group.lone:
        return Peers([obj] * axis_size(axes), axes, True)
    slots = ctx.group.exchange(ctx, obj)
    return Peers([slots[r] for r in _members(ctx, axes)], axes,
                 ctx.rank == 0)


def gather_static(shards: list, dim, dev: torch.device, axes: tuple = (),
                  counts: bool = False, sizes: tuple = ()) -> torch.Tensor:
    """FSDP's parameter all-gather: ``shards`` (one group's blocks of a
    parameter in index order, from :func:`peers`) copied onto ``dev`` and
    concatenated along ``dim``.  ``dim`` may be a tuple, one dimension per
    axis of ``axes`` (of group sizes ``sizes``): ``shards`` are then
    row-major over those axes, each axis's blocks concatenated along its
    dimension.  No barrier: parameters are stable within a step, so this
    also runs in a remat recompute inside the backward.  With ``counts``
    it is counted in :data:`TALLY` as an all-gather over ``axes`` (and,
    when the result takes gradients outside a backward, the
    reduce-scatter of its backward)."""
    moved = [s if s.device == dev else
             s.to(dev, copy=True, non_blocking=dev.type == "cuda")
             for s in shards]
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    out = _cat_grid(moved, dims, tuple(sizes) or (len(moved),))
    if counts and len(shards) > 1:
        n = len(shards)
        TALLY.add("all-gather", tuple(axes), n, _nbytes(out))
        if out.requires_grad and not _in_backward():
            TALLY.add("reduce-scatter", tuple(axes), n, _nbytes(out))
    return out


def _cat_grid(items: list, dims: tuple, sizes: tuple) -> torch.Tensor:
    """``items`` row-major over a grid of ``sizes``, concatenated along
    ``dims[i]`` over grid axis i."""
    if len(dims) == 1:
        return torch.cat(items, dim=dims[0])
    n = math.prod(sizes[1:])
    return torch.cat([_cat_grid(items[i * n:(i + 1) * n], dims[1:],
                                sizes[1:]) for i in range(sizes[0])],
                     dim=dims[0])


@contextlib.contextmanager
def lone_rank(mesh, coords: dict | None = None, axis_names=None):
    """Run the block as the rank at ``coords`` (default every coordinate 0)
    of ``mesh``'s manual axes (``axis_names``, default all), alone in the
    caller's thread: collectives return tensors of the right shape and
    are counted in :data:`TALLY` (see the module docstring)."""
    if in_rank():
        raise RuntimeError("lone_rank inside a shard_map rank")
    manual = tuple(a for a in mesh.axis_names
                   if axis_names is None or a in set(axis_names))
    group = _Group(manual, mesh.shape, lone=True)
    c = {a: 0 for a in manual}
    c.update(coords or {})
    _tls.rank = _Rank(group, group.index(c, manual), c,
                      mesh.devices[tuple(c.get(a, 0)
                                         for a in mesh.axis_names)], None)
    try:
        yield group
    finally:
        _tls.rank = None


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


# A rank index keeps one host thread (``_WORKERS``) and, on each CUDA
# device, one stream (``_STREAMS``) for the life of the process, whatever
# mesh it serves.  PyTorch gives each host thread its own cuBLAS handle and
# keeps one cuBLAS workspace for every (handle, stream) pair it has seen,
# freeing none: with a new thread and a new stream a rank at every call
# and mesh, the pairs, and the device memory they hold, grew with every
# step.  ``_RUN`` lets one shard_map at a time use the workers.
_STREAMS: dict = {}
_WORKERS: list = []
_RUN = threading.Lock()


def _rank_stream(rank: int, dev: torch.device) -> torch.cuda.Stream:
    dev = torch.device("cuda", torch.cuda.current_device()
                       if dev.index is None else dev.index)
    if (rank, dev) not in _STREAMS:
        _STREAMS[(rank, dev)] = torch.cuda.Stream(dev)
    return _STREAMS[(rank, dev)]


def rank_streams(mesh) -> dict:
    """{(rank index, device): stream} of every rank stream made so far on
    the CUDA devices of ``mesh`` (whichever of its axes the shard_maps
    that made them were manual over)."""
    devs = {torch.device("cuda", torch.cuda.current_device()
                         if d.index is None else d.index)
            for d in mesh.devices.flat if d.type == "cuda"}
    return {k: s for k, s in _STREAMS.items() if k[1] in devs}


def _workers(n: int) -> list:
    while len(_WORKERS) < n:
        _WORKERS.append(ThreadPoolExecutor(
            1, thread_name_prefix=f"spmd-rank-{len(_WORKERS)}"))
    return _WORKERS[:n]


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    """``f`` run once per rank of ``mesh``'s manual axes (``axis_names``,
    default all), each rank on its block of every input, from the host
    thread and CUDA stream of its rank index; returns the outputs
    assembled by ``out_specs`` on the mesh's first device."""
    manual = tuple(a for a in mesh.axis_names
                   if axis_names is None or a in set(axis_names))
    sizes = mesh.shape

    def run(*args):
        if in_rank():
            raise RuntimeError("shard_map inside a shard_map rank")
        with _RUN:
            return _run(*args)

    def _run(*args):
        group = _Group(manual, sizes)
        ranks = []
        for pos, dev in zip(
                itertools.product(*(range(sizes[a]) for a in manual)),
                rank_devices(mesh, manual)):
            coords = dict(zip(manual, pos))
            stream = _rank_stream(len(ranks), dev) \
                if dev.type == "cuda" else None
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

        futs = [w.submit(one, c) for w, c in zip(_workers(len(ranks)),
                                                  ranks)]
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

