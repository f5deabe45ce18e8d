from . import convert, metrics, params, prng, stages, topology, workload
from .params import (EngineParams, RuntimeKnobs, SimParams, SimState,
                     SimStructure, grid_from_params, merge_params,
                     stack_knobs)
from .simulator import (SimResult, Static, WindowSamples, build_static,
                        init_state, link_domains, make_lanes, resolve_device,
                        run_window,
                        simulate, simulate_core, simulate_grid,
                        simulate_seeds, wl_arrays)
from .stages import SHARE_POLICIES, EngineCtx, EngineState
from .topology import (FatTree, LeafSpine, Topology, make_fat_tree,
                       make_leaf_spine, scale_for_hosts)
from .workload import Workload, WorkloadBuilder

__all__ = [
    "SimParams", "SimStructure", "RuntimeKnobs", "EngineParams", "SimState",
    "grid_from_params", "merge_params", "stack_knobs",
    "SimResult", "Static", "simulate", "simulate_core", "simulate_seeds",
    "simulate_grid", "build_static", "link_domains", "wl_arrays",
    "resolve_device", "make_lanes", "init_state", "run_window", "WindowSamples",
    "SHARE_POLICIES", "EngineCtx", "EngineState",
    "Topology", "LeafSpine", "FatTree", "make_leaf_spine", "make_fat_tree",
    "scale_for_hosts",
    "Workload", "WorkloadBuilder", "convert", "metrics", "params", "prng", "stages",
    "topology", "workload",
]
