"""Divisibility helper of the reference's sharding rules.

Only :func:`padded` is ported: the model pads head and vocabulary counts up
to a multiple of the tensor-parallel width, which is 1 on one card.  The
mesh rules and ``constrain`` are the identity without a mesh and come with
the parallel slice (ROADMAP queue 1).
"""
from __future__ import annotations

__all__ = ["padded"]


def padded(n: int, tp: int) -> int:
    """Round n up to a multiple of tp."""
    return int(-(-n // tp) * tp)
