"""Fluid-flow network simulator for ring-style collectives, in torch.

Counterpart of ``repro.core.netsim.simulator``.  A run is a Python loop
over ticks of ``dt`` seconds; each tick composes the stage functions of
:mod:`.stages`.  Where the reference ``vmap``s a compiled scan over seeds
and knob points, the port carries a leading *lane* axis through every
stage: ``simulate`` runs one lane, ``simulate_seeds`` one lane per seed,
and ``simulate_grid`` ``K*S`` lanes (knob point ``k``, seed ``s`` at lane
``k*S + s``, row-major).  Lanes never interact.

Devices: every entry point and builder (``build_static``, ``wl_arrays``,
``prng.prng_key``) takes ``device``.  ``None`` means the CUDA card, and
raises when there is none — nothing runs on the CPU unless the caller asks
for ``device="cpu"``.  ``simulate_core``, ``init_state`` and ``run_window``
run where their prepared arrays lie.

Backends: ``SimParams.backend="eager"`` runs the staged torch tick;
``"cuda"`` runs the hot stages in the fused CUDA kernel of
:mod:`repro_torch.kernels.netsim_tick` (its plain torch version on CPU
tensors).  The reference's window kernel (``tick_window > 1``), tiled kernel
(``blk``) and one-hot reductions (``segsum="onehot"``) are not ported yet
and raise ``NotImplementedError``.

Entities: flow slot ``f`` in ``[0, F)``; instance ``(f, w)``, one in-flight
step-send of slot ``f`` (``W`` window slots keyed by ``s % W``); links are
the topology's rows plus one trailing "null" link of infinite capacity.
Time is kept in integer ticks.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .params import (RuntimeKnobs, SimParams, SimState, SimStructure,
                     grid_from_params, lanes_of, merge_params, stack_knobs)
from .stages import (BACKENDS, SHARE_POLICIES, WLArrays, engine_tick,
                     init_state as engine_init_state, make_ctx,
                     resolve_share_policy)
from . import prng
from ...device import resolve_device
from .topology import LEVEL_SPINE, LEVEL_TOR, Topology
from .workload import (Workload, balanced_choice, ecmp_choice, path_table_for,
                       routes_for)

__all__ = [
    "SimParams", "SimStructure", "RuntimeKnobs", "SimResult", "SimState",
    "Static", "WindowSamples",
    "simulate", "simulate_seeds", "simulate_grid", "simulate_core",
    "init_state", "run_window",
    "build_static", "link_domains", "wl_arrays", "grid_from_params",
    "stack_knobs", "resolve_device", "make_lanes",
]


class SimResult(NamedTuple):
    finish_ticks: torch.Tensor      # [F] completion tick per flow slot
    job_finish_ticks: torch.Tensor  # [J]
    # sampled series, every record_every ticks:
    ts_min_wire: torch.Tensor       # [T, J] oldest active wire step (BIG if none)
    ts_max_wire: torch.Tensor       # [T, J] newest active wire step (-1 if none)
    ts_done_min: torch.Tensor       # [T, J] min completed local steps over flows
    ts_throughput: torch.Tensor     # [T, J] delivered bytes/s summed over job
    ts_qmax: torch.Tensor           # [T]    max queue depth (bytes)
    ts_alpha_max: torch.Tensor      # [T]    max Symphony alpha over ports
    # batched entry points prepend leading axes: [S, ...] for
    # simulate_seeds, [K, S, ...] for simulate_grid.


class WindowSamples(NamedTuple):
    """The sampled series of one :func:`run_window` call (same six series
    as :class:`SimResult`, covering only that window's record periods)."""
    ts_min_wire: torch.Tensor
    ts_max_wire: torch.Tensor
    ts_done_min: torch.Tensor
    ts_throughput: torch.Tensor
    ts_qmax: torch.Tensor
    ts_alpha_max: torch.Tensor


class Static(NamedTuple):
    """Per-run arrays; the engine stacks them along a leading lane axis."""
    routes: torch.Tensor        # [F, H] i32 static per-flow paths
    path_table: torch.Tensor    # [F, P, H] i32 ECMP candidate paths per flow
    n_paths: torch.Tensor       # [F] i32 candidate fan-out
    cap: torch.Tensor           # [L+1] f32 bytes/s
    link_dom: torch.Tensor      # [L+1] i32 Symphony domain; D = none
    dom_pad: torch.Tensor       # [D+1] zeros; carries the domain count
    bg_base: torch.Tensor       # [L+1] f32 constant background load
    bg_amp: torch.Tensor        # [L+1] f32 square-wave background amplitude
    bg_period_ticks: torch.Tensor  # i32 scalar
    bg_duty: torch.Tensor          # f32 scalar in [0,1]
    job_weight: torch.Tensor    # [J] f32 weighted-fair share weights
    seed: torch.Tensor          # i32 hash salt


def link_domains(topo: Topology, deploy: str = "tor"
                 ) -> tuple[np.ndarray, int]:
    """Map each link to its Symphony domain (the switch owning its egress
    port) for the deployment tier ``"tor"``, ``"all"`` or ``"spine"``.
    Returns ``(dom [L+1], D)``; undeployed links map to the null domain D.
    """
    lv = topo.switch_level
    if deploy == "tor":
        sel = lv == LEVEL_TOR
    elif deploy == "all":
        sel = lv >= LEVEL_TOR
    elif deploy == "spine":
        sel = lv >= LEVEL_SPINE
    else:
        raise ValueError(f"unknown deploy tier {deploy!r}")
    sw_ids = np.nonzero(sel)[0]
    D = int(sw_ids.shape[0])
    compact = np.full(topo.n_switches, -1, np.int32)
    compact[sw_ids] = np.arange(D, dtype=np.int32)
    dom = np.full(topo.n_links + 1, D, np.int32)
    owned = topo.link_switch >= 0
    mapped = compact[topo.link_switch[owned]]
    dom[:topo.n_links][owned] = np.where(mapped >= 0, mapped, D)
    return dom, D


def build_static(topo: Topology, wl: Workload, routing: str, seed: int,
                 bg_base: np.ndarray | None = None,
                 bg_amp: np.ndarray | None = None,
                 bg_period: float = 1e-3, bg_duty: float = 0.0,
                 dt: float = 10e-6, deploy: str = "tor",
                 job_weight: np.ndarray | None = None,
                 device=None) -> Static:
    device = resolve_device(device)
    if routing == "ecmp":
        choice = ecmp_choice(topo, wl, seed)
    elif routing == "balanced":
        choice = balanced_choice(topo, wl)
    else:
        raise ValueError(routing)
    routes = routes_for(topo, wl, choice)
    paths, n_paths = path_table_for(topo, wl)
    dom, D = link_domains(topo, deploy)
    zb = np.zeros(topo.n_links + 1)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return Static(
        routes=t(routes, torch.int32),
        path_table=t(paths, torch.int32),
        n_paths=t(n_paths, torch.int32),
        cap=t(np.concatenate([topo.link_cap, [1e30]]).astype(np.float32),
              torch.float32),
        link_dom=t(dom, torch.int32),
        dom_pad=torch.zeros(D + 1, dtype=torch.float32, device=device),
        bg_base=t((zb if bg_base is None else np.append(bg_base, 0.0))
                  .astype(np.float32), torch.float32),
        bg_amp=t((zb if bg_amp is None else np.append(bg_amp, 0.0))
                 .astype(np.float32), torch.float32),
        bg_period_ticks=t(max(1, round(bg_period / dt)), torch.int32),
        bg_duty=t(np.float32(bg_duty), torch.float32),
        job_weight=t(np.asarray(np.ones(wl.n_jobs) if job_weight is None
                                else job_weight).astype(np.float32),
                     torch.float32),
        seed=t(seed, torch.int32),
    )


def wl_arrays(wl: Workload, dt: float, device=None) -> WLArrays:
    device = resolve_device(device)

    def i32(x):
        return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)

    def ticks(x):
        return i32(np.round(np.asarray(x) / dt))

    return WLArrays(
        src=i32(wl.src), dst=i32(wl.dst), pred=i32(wl.pred), job=i32(wl.job),
        phase=i32(wl.phase), sps=i32(wl.steps_per_seg),
        pass_steps=i32(wl.pass_steps), total_steps=i32(wl.total_steps()),
        n_phases=i32(wl.n_phases), n_segs=i32(wl.n_passes * wl.n_phases),
        chunk_sched=torch.as_tensor(
            np.asarray(wl.chunk_sched).astype(np.float32), device=device),
        gap_ticks=ticks(wl.compute_gap), start_ticks=ticks(wl.start_time),
        step_offset=i32(wl.step_offset), fstart_ticks=ticks(wl.flow_start),
        trig_job=i32(wl.trig_job), trig_seg=i32(wl.trig_seg),
        trig_delay_ticks=ticks(wl.trig_delay),
    )


def stack_statics(statics: Sequence[Static]) -> Static:
    """Stack per-lane statics along a new leading lane axis."""
    return Static(*(torch.stack(xs) for xs in zip(*statics)))


# ------------------------------------------------------------------- core
def check_structure(struct) -> None:
    """Validate the static structure; raise on parts not ported yet."""
    if struct.backend not in BACKENDS:
        raise ValueError(
            f"unknown tick backend {struct.backend!r}; have {BACKENDS}")
    if struct.share_policy not in SHARE_POLICIES:
        raise ValueError(
            f"unknown share policy {struct.share_policy!r}; "
            f"have {sorted(SHARE_POLICIES)}")
    if struct.segsum != "scatter":
        raise NotImplementedError(
            f"segsum={struct.segsum!r}: the one-hot reductions come with "
            "the tiled kernel in a later slice of the port")
    if struct.blk is not None:
        raise NotImplementedError(
            f"blk={struct.blk}: the tiled tick kernel comes in a later "
            "slice of the port")
    if int(struct.tick_window or 1) != 1:
        raise NotImplementedError(
            f"tick_window={struct.tick_window}: the multi-tick window "
            "kernel comes in the next slice of the port")


def _window_body(ctx, cfg, sim: SimState, n_ticks: int
                 ) -> tuple[SimState, tuple]:
    """Advance every lane ``n_ticks`` ticks from ``sim``, sampling the last
    tick of every ``record_every`` period.  The one windowed engine body:
    the closed-form runs enter it once from tick 0, and :func:`run_window`
    re-enters it from any checkpoint, so a split run replays the same
    ticks.  Samples come back as ``[B, T, ...]``."""
    R = cfg.record_every
    n_rec = n_ticks // R
    state, tick = sim.engine, int(sim.tick)
    rows = []
    with torch.no_grad():
        for _ in range(n_rec):
            for j in range(R):
                state, smp = engine_tick(ctx, cfg, state, tick,
                                         sample=j == R - 1)
                tick += 1
            rows.append(smp)
    if rows:
        samples = tuple(torch.stack(xs, dim=1) for xs in zip(*rows))
    else:
        B, J, dev = ctx.B, ctx.J, ctx.device
        samples = tuple(
            torch.zeros((B, 0) + shape, dtype=dt, device=dev)
            for shape, dt in (((J,), torch.int32), ((J,), torch.int32),
                              ((J,), torch.int32), ((J,), torch.float32),
                              ((), torch.float32), ((), torch.float32)))
    return SimState(tick=tick, engine=state), samples


def _core_impl(st: Static, wl: WLArrays, struct: SimStructure,
               knobs: RuntimeKnobs, key: torch.Tensor) -> SimResult:
    """Init + one full-horizon window over lane-batched ``st``/``knobs``/
    ``key`` (all with leading axis B); returns ``[B, ...]`` results."""
    cfg = merge_params(struct, knobs)
    resolve_share_policy(cfg)
    ctx = make_ctx(st, wl, cfg.window)
    sim0 = SimState(tick=0, engine=engine_init_state(ctx, key))
    sim, samples = _window_body(ctx, cfg, sim0, cfg.n_ticks)
    return SimResult(sim.engine.finish, sim.engine.job_finish, *samples)


def simulate_core(st: Static, wl: WLArrays, cfg, knobs_or_key, key=None
                  ) -> SimResult:
    """One run from prepared arrays.  Two call forms, as in the reference:

    * ``simulate_core(st, wl, structure, knobs, key)``
    * ``simulate_core(st, wl, sim_params, key)``

    ``st``/``wl`` carry no lane axis and fix the device; ``key`` is a
    :func:`prng.prng_key`."""
    if isinstance(cfg, SimParams):
        if key is not None:
            raise TypeError("legacy form is simulate_core(st, wl, cfg, key)")
        struct, knobs = cfg.split()
        key = knobs_or_key
    else:
        struct, knobs = cfg, knobs_or_key
    check_structure(struct)
    dev = st.cap.device
    sts = Static(*(x[None] for x in st))
    kns = knobs.map(lambda x: x.reshape(1).to(dev))
    res = _core_impl(sts, wl, struct, kns, key.reshape(1, 2).to(dev))
    return SimResult(*(x[0] for x in res))


def _resolve_routing(cfg, routing: str):
    """Routing modes: 'ecmp' (per-step re-hash, default), 'ecmp_flow'
    (persistent per-flow paths), 'balanced' (static round-robin)."""
    if routing == "ecmp":
        return cfg._replace(per_step_ecmp=True), "ecmp"
    if routing == "ecmp_flow":
        return cfg._replace(per_step_ecmp=False), "ecmp"
    if routing == "balanced":
        return cfg._replace(per_step_ecmp=False), "balanced"
    raise ValueError(routing)


def simulate(topo: Topology, wl: Workload, cfg: SimParams,
             routing: str = "ecmp", seed: int = 0,
             bg_base: np.ndarray | None = None,
             bg_amp: np.ndarray | None = None,
             bg_period: float = 1e-3, bg_duty: float = 0.0,
             job_weight: np.ndarray | None = None,
             device=None) -> SimResult:
    """Single-run entry point (one lane)."""
    dev = resolve_device(device)
    cfg, mode = _resolve_routing(cfg, routing)
    st = build_static(topo, wl, mode, seed, bg_base, bg_amp, bg_period,
                      bg_duty, cfg.dt, deploy=cfg.deploy,
                      job_weight=job_weight, device=dev)
    return simulate_core(st, wl_arrays(wl, cfg.dt, dev), cfg,
                         prng.prng_key(seed, dev))


def simulate_seeds(topo: Topology, wl: Workload, cfg: SimParams,
                   routing: str, seeds: Sequence[int], device=None,
                   **bg) -> SimResult:
    """One lane per seed: both the ECMP path draw and the DCQCN coin flips
    vary.  Result arrays gain a leading ``[S]`` axis."""
    struct, knobs = cfg.split()
    res = simulate_grid(topo, wl, struct, knobs.map(lambda x: x[None]),
                        seeds, routing=routing, device=device, **bg)
    return SimResult(*(x[0] for x in res))


def simulate_grid(topo: Topology, wl: Workload, struct: SimStructure,
                  knobs_grid, seeds: Sequence[int] = (0,),
                  routing: str = "ecmp", chunk_knobs: int | None = None,
                  device=None, **bg) -> SimResult:
    """Batched grid executor: knob points x seeds as lanes of one run.

    ``knobs_grid`` is a stacked :class:`RuntimeKnobs` (leading axis K) or a
    sequence of per-point ``RuntimeKnobs`` / ``SimParams`` (sharing
    ``struct``'s static fields).  Lanes are the flattened ``K*S`` cross
    product, row-major; ``chunk_knobs`` runs at most that many knob points
    at a time to bound memory.  Returns arrays with leading ``[K, S]``.
    """
    dev = resolve_device(device)
    if isinstance(knobs_grid, (list, tuple)) and \
            not isinstance(knobs_grid, RuntimeKnobs):
        for p in knobs_grid:
            if isinstance(p, SimParams) and p.structure() != struct:
                raise ValueError(
                    "grid point differs from struct in static fields; "
                    "use grid_from_params to derive a common structure")
        knobs_grid = stack_knobs([p.knobs() if isinstance(p, SimParams)
                                  else p for p in knobs_grid])
    check_structure(struct)
    K = lanes_of(knobs_grid)
    S = len(seeds)
    chunk = K if chunk_knobs is None else max(1, min(int(chunk_knobs), K))
    outs = []
    for i in range(0, K, chunk):
        kn = knobs_grid.map(lambda x: x[i:i + chunk])
        ctx, cfg, sim0 = make_lanes(topo, wl, struct, kn, seeds, routing,
                                    dev, **bg)
        sim, samples = _window_body(ctx, cfg, sim0, cfg.n_ticks)
        res = SimResult(sim.engine.finish, sim.engine.job_finish, *samples)
        outs.append(SimResult(*(x.reshape((lanes_of(kn), S) + x.shape[1:])
                                for x in res)))
    if len(outs) == 1:
        return outs[0]
    return SimResult(*(torch.cat(xs, dim=0) for xs in zip(*outs)))


def make_lanes(topo: Topology, wl: Workload, struct: SimStructure,
               knobs: RuntimeKnobs, seeds: Sequence[int],
               routing: str = "ecmp", device=None, **bg):
    """Set up the lanes of a grid — knob point ``k`` x seed ``s`` at lane
    ``k*S + s`` — and return ``(ctx, cfg, tick-0 SimState)`` on
    ``device``, ready for the engine's tick functions."""
    dev = resolve_device(device)
    struct, mode = _resolve_routing(struct, routing)
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    statics = stack_statics([
        build_static(topo, wl, mode, s, dt=struct.dt, deploy=struct.deploy,
                     device=dev, **bg) for s in seeds])
    knobs = knobs.map(lambda x: x.reshape(-1))
    lane_seed = torch.arange(lanes_of(knobs) * S, device=dev) % S
    sts = Static(*(x[lane_seed] for x in statics))
    cfg = merge_params(struct,
                       knobs.map(lambda x: x.to(dev).repeat_interleave(S)))
    resolve_share_policy(cfg)
    ctx = make_ctx(sts, wl_arrays(wl, struct.dt, dev), cfg.window)
    keys = prng.prng_key(seeds, dev)[lane_seed]
    return ctx, cfg, SimState(tick=0, engine=engine_init_state(ctx, keys))


# ---------------------------------------------- windowed checkpoint / resume
def init_state(st: Static, wl: WLArrays, struct: SimStructure,
               key=0) -> SimState:
    """The tick-0 :class:`SimState` of one simulation (engine arrays carry
    a lane axis of 1).  ``key`` is a :func:`prng.prng_key` or an int seed.
    """
    check_structure(struct)
    dev = st.cap.device
    if not isinstance(key, torch.Tensor):
        key = prng.prng_key(int(key), dev)
    ctx = make_ctx(Static(*(x[None] for x in st)), wl, struct.window)
    return SimState(tick=0,
                    engine=engine_init_state(ctx, key.reshape(1, 2)))


def run_window(st: Static, wl: WLArrays, struct: SimStructure,
               knobs: RuntimeKnobs, state: SimState, n_ticks: int
               ) -> tuple[SimState, WindowSamples]:
    """Advance a checkpointed simulation by ``n_ticks`` ticks.

    ``n_ticks`` must be a positive multiple of ``struct.record_every``, so
    that the samples of split runs concatenate to the one-shot series.
    Knob values may change between windows.  Resumed runs are bit-for-bit
    equal to one-shot :func:`simulate_core` runs.
    """
    check_structure(struct)
    R = struct.record_every
    n_ticks = int(n_ticks)
    if n_ticks <= 0 or n_ticks % R:
        raise ValueError(
            f"n_ticks must be a positive multiple of record_every={R} "
            f"(samples are taken on the record grid), got {n_ticks}")
    dev = st.cap.device
    cfg = merge_params(struct, knobs.map(lambda x: x.reshape(1).to(dev)))
    resolve_share_policy(cfg)
    ctx = make_ctx(Static(*(x[None] for x in st)), wl, cfg.window)
    sim, samples = _window_body(ctx, cfg, state, n_ticks)
    return sim, WindowSamples(*(x[0] for x in samples))
