"""The netsim tick kernels: the fused single tick and the multi-tick window
as CUDA kernels (``kernel``, ``window``), their plain torch versions
(``ref``) and engine entry points (``ops``)."""
from .kernel import TickOut, build, build_all, kernel_policy, netsim_tick
from .ops import (compose_tick, engine_tick_fused, engine_window_fused,
                  fused_tick, tick_operands)
from .ref import hot_tick, window_ref
from .window import kernel_math, netsim_window, window_operands

__all__ = ["TickOut", "netsim_tick", "hot_tick", "fused_tick",
           "compose_tick", "engine_tick_fused", "kernel_policy",
           "tick_operands", "build", "build_all", "netsim_window",
           "window_ref", "window_operands", "engine_window_fused",
           "kernel_math"]
