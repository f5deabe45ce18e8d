"""Device meshes: named axes over an array of devices.

The port of ``repro/launch/mesh.py``.  Single pod: 16 x 16 = 256 chips,
axes (data, model).  Multi-pod: 2 x 16 x 16 = 512 chips, axes (pod, data,
model); 'pod' is outer data parallelism over the DCN tier, the Ethernet
fabric whose ring-step misalignment Symphony manages.

A :class:`Mesh` is the port's stand-in for ``jax.sharding.Mesh``: axis
names, their sizes, and a ``torch.device`` at every coordinate.  A device
may be named more than once (``["cuda"] * 4``: four ranks on one card, each
with its own host thread and CUDA stream under
:func:`~repro_torch.parallel.spmd.shard_map`), or be the CPU (``["cpu"] *
8``, as the tests run it).  Without ``devices`` a mesh takes the CUDA cards
and raises when there are fewer than it needs; nothing falls back to the
CPU.  Building a mesh touches no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_production_mesh"]


@dataclass(eq=False)
class Mesh:
    """``devices`` is an object array of ``torch.device`` of the mesh's
    shape, axes in the order of ``axis_names``."""
    axis_names: tuple[str, ...]
    devices: np.ndarray

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _cuda_cards(n: int, what: str) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"{what} needs {n} CUDA devices, this host has {have}; name the "
            "devices (e.g. devices=['cuda'] * n, or ['cpu'] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, so that devices compare
    equal to the tensors' own."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  ``devices``: a sequence of
    ``prod(shape)`` devices (``torch.device`` or names, repeats allowed),
    laid out row-major; ``None`` takes the first ``prod(shape)`` CUDA
    cards and raises when the host has fewer."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if devices is None:
        devs = _cuda_cards(n, f"a {shape} mesh")
    else:
        devs = [_indexed(torch.device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {shape} mesh needs {n} devices, got "
                             f"{len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(axes, arr.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(devices=None) -> Mesh:
    """Every CUDA card (or ``devices``) on a 1-D 'data' mesh; raises on a
    host without a card."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = _cuda_cards(max(n, 1), "make_host_mesh")
    return make_mesh((len(devices),), ("data",), devices)
