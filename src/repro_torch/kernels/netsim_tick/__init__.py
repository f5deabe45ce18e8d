"""The netsim tick kernels: the fused single tick, the multi-tick window and
the tiled tick as CUDA kernels (``kernel``, ``window``, ``tiled``), their
plain torch versions (``ref``) and engine entry points (``ops``)."""
from .kernel import (TickOut, build, build_all, hot_smem_split, kernel_policy,
                     netsim_tick)
from .ops import (compose_tick, engine_tick_fused, engine_window_fused,
                  fused_tick, tick_operands, tiled_operands)
from .ref import hot_tick, tiled_tick_ref, window_ref
from .tiled import netsim_tiled, tiled_smem_bytes
from .window import (kernel_math, netsim_window, window_operands,
                     window_smem_split)

__all__ = ["TickOut", "netsim_tick", "hot_tick", "fused_tick",
           "compose_tick", "engine_tick_fused", "kernel_policy",
           "tick_operands", "build", "build_all", "netsim_window",
           "window_ref", "window_operands", "engine_window_fused",
           "kernel_math", "netsim_tiled", "tiled_tick_ref", "tiled_operands",
           "tiled_smem_bytes", "hot_smem_split", "window_smem_split"]
