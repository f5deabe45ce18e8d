"""Carry simulator state across from the JAX reference to the port.

The port's tests feed one state to both engines: the reference's
``Static``, ``WLArrays`` and ``EngineState``/``SimState`` are read field by
field (by name, as numpy arrays — nothing of the reference is imported) and
returned as the port's tensors on ``device`` (``None``: the CUDA card).
Per-run arrays gain the port's leading lane axis of 1; the workload arrays
stay lane-free.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from .params import SimState
from .simulator import Static
from .stages import EngineState, WLArrays

__all__ = ["static_from_reference", "wl_from_reference",
           "engine_state_from_reference", "sim_state_from_reference"]

_INT_STATIC = {"routes", "path_table", "n_paths", "link_dom",
               "bg_period_ticks", "seed"}
_FLOAT_STATE = {"sent", "rate", "target", "alpha_cc", "lam", "q",
                "s_psnwin", "s_alpha", "s_cnt", "s_cntop"}


def _tensor(obj, name: str, dtype: torch.dtype, device, lane: bool):
    x = np.asarray(getattr(obj, name))
    t = torch.as_tensor(x.astype(np.float32 if dtype == torch.float32
                                 else np.int64)).to(dtype)
    return (t[None] if lane else t).to(resolve_device(device))


def static_from_reference(st, device=None) -> Static:
    """The reference's per-run ``Static`` -> the port's, lane axis of 1."""
    return Static(**{
        f: _tensor(st, f, torch.int32 if f in _INT_STATIC else torch.float32,
                   device, lane=True)
        for f in Static._fields})


def wl_from_reference(wl, device=None) -> WLArrays:
    """The reference's ``WLArrays`` -> the port's (shared by all lanes)."""
    return WLArrays(**{
        f: _tensor(wl, f, torch.float32 if f == "chunk_sched" else
                   torch.int32, device, lane=False)
        for f in WLArrays._fields})


def engine_state_from_reference(es, device=None) -> EngineState:
    """The reference's ``EngineState`` -> the port's, lane axis of 1.  The
    uint32 PRNG key words become the port's int64 key."""
    fields = {}
    for f in EngineState._fields:
        if f == "key":
            fields[f] = _tensor(es, f, torch.int64, device, lane=True)
        else:
            fields[f] = _tensor(
                es, f, torch.float32 if f in _FLOAT_STATE else torch.int32,
                device, lane=True)
    return EngineState(**fields)


def sim_state_from_reference(ss, device=None) -> SimState:
    """The reference's ``SimState`` (tick cursor + engine state)."""
    return SimState(tick=int(np.asarray(ss.tick)),
                    engine=engine_state_from_reference(ss.engine, device))
