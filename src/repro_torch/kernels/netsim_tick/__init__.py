"""The fused netsim tick: CUDA kernel (``kernel``), plain torch version
(``ref``) and engine entry points (``ops``)."""
from .kernel import TickOut, netsim_tick
from .ops import (compose_tick, engine_tick_fused, fused_tick,
                  kernel_policy, tick_operands)
from .ref import hot_tick

__all__ = ["TickOut", "netsim_tick", "hot_tick", "fused_tick",
           "compose_tick", "engine_tick_fused", "kernel_policy",
           "tick_operands"]
