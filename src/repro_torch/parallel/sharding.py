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
blocks under :func:`~.spmd.shard_map`.  GSPMD's partitioning of the axes
outside a ``shard_map`` has no counterpart in the port (ROADMAP queue 1
item 1, left 6), so :func:`constrain` checks its axes and returns its
input unchanged, as ``with_sharding_constraint`` leaves values unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from .spmd import PartitionSpec as P
from .spmd import manual_axes

__all__ = ["BASE_RULES", "make_rules", "mesh_axis_size", "padded",
           "spec_for", "NamedSharding", "sharding_for", "constrain"]

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


def constrain(x, axes: Sequence[str | None],
              rules: Mapping[str, tuple[str, ...] | None] | None, mesh):
    """The reference's ``with_sharding_constraint`` by logical axes (no-op
    without mesh/rules), which never changes values: returns ``x`` as it
    is, after dropping the axes that are manual in the surrounding
    ``shard_map`` rank and checking the spec against ``x``'s rank."""
    if mesh is None or rules is None or mesh.size == 1:
        return x
    manual = manual_axes()
    if manual:
        rules = {k: (tuple(a for a in v if a not in manual) or None)
                 if v is not None else None for k, v in rules.items()}
    spec = spec_for(axes, rules, mesh)
    if len(spec) > x.ndim:
        raise ValueError(f"sharding {spec} for a tensor of {x.ndim} "
                         "dimensions")
    return x
