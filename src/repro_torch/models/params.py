"""Declarative parameter trees.

Models declare parameters as `ParamSpec` descriptors (shape + logical axes +
initializer), as the reference does (``repro/models/params.py``).  The same
tree sizes a model without allocating it (:func:`count_params`,
:func:`param_bytes`) and materializes it as ``nn.ParameterDict``s
(:func:`module_from_spec`, :func:`init_tree`).

The port keeps one tree entry per layer where the reference stacks a
leading ``[n_groups]`` axis; ``ParamSpec.stack`` records that axis so that
the fan-in rule, which counts every axis but the last, gives the same
standard deviation as the reference's stacked leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator

import torch
from torch import nn

__all__ = ["ParamSpec", "tree_leaves_with_path", "count_params",
           "param_bytes", "cast_tree", "init_leaf", "init_tree", "param_at",
           "module_from_spec"]


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


ParamTree = dict  # nested dict[str, ParamTree | ParamSpec]


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
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).itemsize
               for _, s in tree_leaves_with_path(tree))


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
    x = torch.empty(spec.shape, dtype=torch.float32, device=out.device)
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
