"""Trace-time feature flags.

The port of ``repro/flags.py``.

ROOFLINE_MODE: the reference's roofline lowering traces a loop-free
program, because XLA's cost analysis counts a while-loop body once.  The
port's dry-run counts an eager program, where every trip is counted, but
``--roofline`` keeps the same loop-free routes so that the two packages'
records line up: unchunked cross-entropy and attention, the MoE dispatch
in one chunk of all tokens, and the SSD scan vectorized over chunks
(``ssm.ssd_reference_vec``).

SSD_BF16: ``ssd_reference_vec`` keeps its O(Q^2) decay and score tensors
in bf16 (the cumulative sums, exponentials and the inter-chunk state stay
float32).

RING_SYNC_DTYPE: the dtype, by the reference's name, in which the explicit
ring gradient sync (``collectives/scheduler.py``) moves gradients.
"""
from __future__ import annotations

import torch

__all__ = ["ROOFLINE_MODE", "SSD_BF16", "RING_SYNC_DTYPE", "set_roofline",
           "set_ssd_bf16", "set_ring_sync_dtype", "ring_sync_dtype"]

ROOFLINE_MODE = False
SSD_BF16 = False
RING_SYNC_DTYPE = "float32"


def set_roofline(v: bool) -> None:
    global ROOFLINE_MODE
    ROOFLINE_MODE = bool(v)


def set_ssd_bf16(v: bool) -> None:
    global SSD_BF16
    SSD_BF16 = bool(v)


def set_ring_sync_dtype(d: str) -> None:
    """``d``: a dtype's name as the reference spells it ("float32",
    "bfloat16", ...); raises ``ValueError`` for a name torch lacks."""
    global RING_SYNC_DTYPE
    if not isinstance(getattr(torch, str(d), None), torch.dtype):
        raise ValueError(f"unknown dtype name {d!r}")
    RING_SYNC_DTYPE = str(d)


def ring_sync_dtype() -> torch.dtype:
    """``RING_SYNC_DTYPE`` as a ``torch.dtype``."""
    return getattr(torch, RING_SYNC_DTYPE)
