"""Logical-axis sharding rules (MaxText-style) for the production mesh.

The port of ``repro/parallel/sharding.py``.  Weights and activations carry
*logical* axis names; a rules table maps them to mesh axes.  The production
mesh is ('data','model') intra-pod and ('pod','data','model') across pods
('pod' = outer data parallelism over the DCN tier, the fabric Symphony
targets).

Divisibility policy: when a logical axis maps to mesh axes whose product
does not divide the dimension, the model pads the dimension up (standard
Megatron-style head/vocab padding).  `padded(n, tp)` computes that.

The specs are the port's own :class:`~.spmd.PartitionSpec`; they place
blocks under :func:`~.spmd.shard_map`.  GSPMD's partitioning of the
``model`` axis is ported for the dense GQA, MoE, SSM and hybrid families
as an explicit per-rank program (``models/lm.py``): :func:`shard_tensor`
/ :func:`shard_of` cut a global tensor into the ranks' blocks by its spec
(rank order: row-major over every mesh axis, :func:`~.spmd.shard_map`'s
order when it is manual over all of them) and :func:`gather_shards` puts
them back.  :func:`constrain` never changes values (as
``with_sharding_constraint``); inside a rank that is manual over a
``model`` axis larger than 1 it checks a tensor's local shape against
its spec's block of the global shape it is given, and raises on a
mismatch.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from . import spmd
from .spmd import PartitionSpec as P
from .spmd import manual_axes

__all__ = ["BASE_RULES", "make_rules", "mesh_axis_size", "padded",
           "spec_for", "NamedSharding", "sharding_for", "constrain",
           "spec_axes", "local_shape", "shard_of", "shard_tensor",
           "gather_shards", "mesh_coords", "RankShards", "batch_axes",
           "part_axes"]

# weight rules -------------------------------------------------------------
BASE_RULES: dict[str, tuple[str, ...] | None] = {
    # weights
    "vocab": ("model",),
    "embed": None,               # FSDP overrides to ("data",)
    "heads": ("model",),
    "kv_heads": None,            # kv heads replicated under TP (vLLM-style)
    "head_dim": None,
    "mlp": ("model",),
    "experts": ("model",),       # expert parallelism
    "expert_mlp": None,
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "state": None,
    "conv": None,
    "q_lora": ("model",),
    "kv_lora": None,
    "layers": None,
    "norm": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": ("model",),        # sequence-parallel residuals at remat
                                 # boundaries (Megatron-SP style)
    "kv_seq": None,              # decode KV cache; overridden for seq-sharding
    "act_embed": None,
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_experts": ("model",),
}


def make_rules(*, fsdp: bool = False, seq_shard_decode: bool = False,
               overrides: Mapping[str, tuple[str, ...] | None] | None = None
               ) -> dict[str, tuple[str, ...] | None]:
    rules = dict(BASE_RULES)
    if fsdp:
        rules["embed"] = ("data",)
        rules["expert_mlp"] = ("data",)
    if seq_shard_decode:
        rules["kv_seq"] = ("data",)
    if overrides:
        rules.update(overrides)
    return rules


def mesh_axis_size(mesh, axes: tuple[str, ...] | None) -> int:
    if not axes:
        return 1
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def batch_axes(mesh, batch: int) -> tuple[str, ...] | None:
    """The largest prefix of ("pod", "data") that divides ``batch``: the
    axes a batch is split over (``None`` when none does)."""
    axes, n = [], 1
    for a in ("pod", "data"):
        if a in mesh.shape and batch % (n * mesh.shape[a]) == 0:
            axes.append(a)
            n *= mesh.shape[a]
    return tuple(axes) if axes else None


def padded(n: int, tp: int) -> int:
    """Round n up to a multiple of tp."""
    return int(-(-n // tp) * tp)


def spec_for(axes: Sequence[str | None],
             rules: Mapping[str, tuple[str, ...] | None], mesh) -> P:
    """Logical axes -> PartitionSpec, dropping mesh axes absent in `mesh`
    (so the same rules serve single-pod and multi-pod meshes)."""
    parts = []
    used: set[str] = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is None:
            parts.append(None)
            continue
        keep = tuple(x for x in m if x in mesh.shape and x not in used)
        used.update(keep)
        parts.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec placed on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P


def sharding_for(axes: Sequence[str | None],
                 rules: Mapping[str, tuple[str, ...] | None],
                 mesh) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, rules, mesh))


def part_axes(part) -> tuple[str, ...]:
    """The mesh axes of one entry of a PartitionSpec."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_axes(spec: P) -> set[str]:
    """Every mesh axis a spec names."""
    return {a for part in spec for a in part_axes(part)}


def local_shape(shape: Sequence[int], spec: P, mesh) -> tuple[int, ...]:
    """A rank's block of a tensor of ``shape`` under ``spec``: each
    dimension divided by the product of its mesh axes (which must divide
    it; the model pads heads and vocabulary so that they do)."""
    out = list(shape)
    for i, part in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in part_axes(part))
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split over {part} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def mesh_coords(mesh) -> list[dict]:
    """Every rank's coordinates, row-major over the mesh's axes."""
    return [dict(zip(mesh.axis_names, pos)) for pos in itertools.product(
        *(range(mesh.shape[a]) for a in mesh.axis_names))]


def _index(coords: dict, axes: tuple[str, ...], mesh) -> int:
    r = 0
    for a in axes:
        r = r * mesh.shape[a] + coords[a]
    return r


def shard_of(x: torch.Tensor, spec: P, mesh, coords: dict) -> torch.Tensor:
    """The block of ``x`` (a view) of the rank at ``coords``."""
    for d, part in enumerate(spec):
        axes = part_axes(part)
        if not axes:
            continue
        k = x.shape[d] // math.prod(mesh.shape[a] for a in axes)
        x = x.narrow(d, _index(coords, axes, mesh) * k, k)
    return x


def shard_tensor(x: torch.Tensor, spec: P, mesh) -> list[torch.Tensor]:
    """Each rank's block of ``x`` as a copy on that rank's device, in rank
    order (row-major over the mesh's axes)."""
    local_shape(x.shape, spec, mesh)            # raises unless it divides
    out = []
    for c in mesh_coords(mesh):
        dev = mesh.devices[tuple(c[a] for a in mesh.axis_names)]
        out.append(shard_of(x, spec, mesh, c).to(dev, copy=True))
    return out


def gather_shards(shards: Sequence[torch.Tensor], spec: P, mesh,
                  device=None) -> torch.Tensor:
    """The global tensor of the ranks' blocks (rank order as in
    :func:`shard_tensor`) on ``device`` (default the first block's);
    replicas are read from the ranks at coordinate 0 of the axes the spec
    does not name."""
    first = shards[0]
    dev = first.device if device is None else torch.device(device)
    shape = list(first.shape)
    for d, part in enumerate(spec):
        shape[d] *= math.prod(mesh.shape[a] for a in part_axes(part))
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    named = spec_axes(spec)
    for c, piece in zip(mesh_coords(mesh), shards):
        if any(c[a] for a in mesh.axis_names if a not in named):
            continue
        view = out
        for d, part in enumerate(spec):
            axes = part_axes(part)
            if axes:
                view = view.narrow(d, _index(c, axes, mesh) * piece.shape[d],
                                   piece.shape[d])
        view.copy_(piece)
    return out


@dataclass
class RankShards:
    """A leaf handed to the ranks of a mesh: ``shards[r]`` is rank r's block
    (rank order as in :func:`shard_tensor`) under ``sharding``."""
    sharding: "NamedSharding"
    shards: list

    def full(self, device=None) -> torch.Tensor:
        return gather_shards(self.shards, self.sharding.spec,
                             self.sharding.mesh, device)


def constrain(x, axes: Sequence[str | None],
              rules: Mapping[str, tuple[str, ...] | None] | None, mesh,
              shape: Sequence[int] | None = None):
    """The reference's ``with_sharding_constraint`` by logical axes (no-op
    without mesh/rules), which never changes values: returns ``x`` as it
    is, after checking the spec against ``x``'s rank.  Inside a
    ``shard_map`` rank the manual axes drop out of the rules, except in a
    tensor-parallel rank (manual over a ``model`` axis larger than 1):
    there ``x`` is this rank's block, and with the global ``shape`` given
    its shape must be the spec's block of it (``ValueError`` otherwise)."""
    if mesh is None or rules is None or mesh.size == 1:
        return x
    manual = manual_axes()
    tp_rank = "model" in manual and spmd.axis_size("model") > 1
    if manual and not tp_rank:
        rules = {k: (tuple(a for a in v if a not in manual) or None)
                 if v is not None else None for k, v in rules.items()}
    spec = spec_for(axes, rules, mesh)
    if len(spec) > x.ndim:
        raise ValueError(f"sharding {spec} for a tensor of {x.ndim} "
                         "dimensions")
    if tp_rank and shape is not None:
        want = local_shape(shape, spec, mesh)
        if tuple(x.shape) != want:
            raise ValueError(f"a rank's block of {tuple(shape)} under "
                             f"{spec} is {want}, the tensor is "
                             f"{tuple(x.shape)}")
    return x
