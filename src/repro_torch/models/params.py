"""Declarative parameter trees.

Models declare parameters as `ParamSpec` descriptors (shape + logical axes +
initializer), as the reference does (``repro/models/params.py``).  The same
tree sizes a model without allocating it (:func:`count_params`,
:func:`param_bytes`), materializes it as ``nn.ParameterDict``s
(:func:`module_from_spec`, :func:`init_tree`), and describes it for the
dry-run: :func:`abstract_tree` gives a :class:`ShapeDtypeStruct` a leaf
(shape, dtype and its sharding on a mesh, nothing allocated),
:func:`shardings_tree` the shardings alone, and :func:`shard_shape` /
:func:`shard_bytes` what one device holds of a leaf.

The port keeps one tree entry per layer where the reference stacks a
leading ``[n_groups]`` axis; ``ParamSpec.stack`` records that axis so that
the fan-in rule, which counts every axis but the last, gives the same
standard deviation as the reference's stacked leaf.  The stacked axis is
the reference's logical axis ``"layers"``, which no rule maps to a mesh
axis, so a per-layer leaf's sharding is the stacked leaf's without its
first entry, and the per-layer leaves of a stack hold as many bytes a
device as the stacked leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator

import torch
from torch import nn

from ..parallel.sharding import NamedSharding, sharding_for

__all__ = ["ParamSpec", "ShapeDtypeStruct", "tree_leaves_with_path",
           "count_params", "param_bytes", "cast_tree", "init_leaf",
           "init_tree", "param_at", "module_from_spec", "abstract_tree",
           "shardings_tree", "shard_shape", "shard_bytes", "unflatten", "slot"]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"          # fan_in | normal | zeros | ones | constant
    scale: float = 1.0
    dtype: Any = torch.bfloat16
    stack: int = 1                # layers the reference stacks this leaf over

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """A tensor's description without its values (``jax.ShapeDtypeStruct``):
    shape, dtype and, when it is placed on a mesh, its sharding."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None


ParamTree = dict  # nested dict[str, ParamTree | ParamSpec]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def shard_shape(shape: tuple[int, ...], sharding: NamedSharding | None
                ) -> tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``sharding``: each
    dimension over the product of its mesh axes, rounded up (what XLA
    allocates a device for an evenly tiled sharding); the whole shape
    without a sharding."""
    if sharding is None:
        return tuple(shape)
    sizes = sharding.mesh.shape
    out = list(shape)
    for i, part in enumerate(sharding.spec):
        if part is None:
            continue
        n = math.prod(sizes[a] for a in
                      ((part,) if isinstance(part, str) else part))
        out[i] = -(-out[i] // n)
    return tuple(out)


def shard_bytes(x) -> int:
    """Bytes one device holds of ``x`` (a :class:`ShapeDtypeStruct`)."""
    return math.prod(shard_shape(x.shape, x.sharding)) * _itemsize(x.dtype)


def tree_leaves_with_path(tree: ParamTree, prefix=()
                          ) -> Iterator[tuple[tuple, ParamSpec]]:
    for k, v in tree.items():
        if isinstance(v, ParamSpec):
            yield prefix + (k,), v
        else:
            yield from tree_leaves_with_path(v, prefix + (k,))


def count_params(tree: ParamTree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves_with_path(tree))


def param_bytes(tree: ParamTree) -> int:
    return sum(math.prod(s.shape) * _itemsize(s.dtype)
               for _, s in tree_leaves_with_path(tree))


def unflatten(flat: dict) -> dict:
    """Nested dicts from ``{path tuple: leaf}``."""
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def abstract_tree(tree: ParamTree, rules, mesh) -> dict:
    """The tree's leaves as :class:`ShapeDtypeStruct`s, each with its
    sharding under ``rules`` on ``mesh`` (none without a mesh)."""
    return unflatten({
        path: ShapeDtypeStruct(
            spec.shape, spec.dtype,
            None if mesh is None else sharding_for(spec.axes, rules, mesh))
        for path, spec in tree_leaves_with_path(tree)})


def shardings_tree(tree: ParamTree, rules, mesh) -> dict:
    """Each leaf's sharding under ``rules`` on ``mesh``."""
    return unflatten({path: sharding_for(spec.axes, rules, mesh)
                       for path, spec in tree_leaves_with_path(tree)})


def init_leaf(out: torch.Tensor, spec: ParamSpec,
              generator: torch.Generator) -> None:
    """Fill ``out`` by the reference's rules (``params.py:51-67``): zeros,
    ones, a constant, or a normal truncated at +-3 standard units times
    ``scale`` (``normal``) or ``scale / sqrt(fan_in)`` (``fan_in``: the
    product of every axis but the last, the stacked layer axis included)."""
    if spec.init == "zeros":
        out.zero_()
        return
    if spec.init == "ones":
        out.fill_(1.0)
        return
    if spec.init == "constant":
        out.fill_(spec.scale)
        return
    if spec.init == "fan_in":
        fan = spec.stack * math.prod(spec.shape[:-1]) \
            if len(spec.shape) > 1 else spec.shape[0]
        std = spec.scale / math.sqrt(max(1, fan))
    elif spec.init == "normal":
        std = spec.scale
    else:
        raise ValueError(f"unknown initializer {spec.init!r}")
    # ``out`` may be a rank's block of the leaf: the draw takes its shape,
    # the standard deviation the whole leaf's fan-in
    x = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=generator)
    out.copy_(x * std)


def module_from_spec(tree: ParamTree, device) -> nn.Module:
    """Uninitialized parameters of ``tree`` on ``device``: an
    ``nn.ParameterDict`` for a dict of specs, an ``nn.ModuleDict`` of those
    for a dict of subtrees."""
    if all(isinstance(v, ParamSpec) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.empty(s.shape, dtype=s.dtype,
                                        device=device))
            for k, s in tree.items()})
    if any(isinstance(v, ParamSpec) for v in tree.values()):
        raise ValueError(f"tree level mixes specs and subtrees: {list(tree)}")
    return nn.ModuleDict({k: module_from_spec(v, device)
                          for k, v in tree.items()})


def param_at(module: nn.Module, path: tuple) -> torch.Tensor:
    """The parameter of ``module`` at a tree path of its spec."""
    for k in path:
        if isinstance(module, nn.ModuleList):
            module = module[int(k)]
        elif isinstance(module, (nn.ModuleDict, nn.ParameterDict)):
            module = module[k]
        else:
            module = getattr(module, k)
    return module


def slot(module: nn.Module, name: str) -> tuple[nn.Module, str]:
    """The module holding parameter ``name`` (``"blocks.0.attn.wq"``) and
    the parameter's key in it (to swap the tensor in its slot)."""
    *path, key = name.split(".")
    for k in path:
        module = module._modules[k]
    return module, key


@torch.no_grad()
def init_tree(module: nn.Module, tree: ParamTree,
              generator: torch.Generator) -> None:
    """Initialize every parameter of ``module`` (built from ``tree``) in the
    tree's order from one generator on the parameters' device."""
    for path, spec in tree_leaves_with_path(tree):
        init_leaf(param_at(module, path), spec, generator)


@torch.no_grad()
def cast_tree(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter of ``module`` to ``dtype`` in place."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
