"""Simulator configuration, split into static structure and per-lane knobs.

Counterpart of ``repro.core.netsim.params``:

* :class:`SimStructure` — everything that fixes shapes or control flow
  (tick count, window, sampling period, share policy, deployment tier,
  routing mode, tick backend).  Hashable.
* :class:`RuntimeKnobs` — every numeric control knob (RED, DCQCN, Symphony,
  the ``sym_on``/``pq_on`` 0/1 gates) as float32/int32 tensors.  A single
  point holds 0-d tensors; :func:`stack_knobs` stacks points along a
  leading axis, and the simulator runs one *lane* per entry.
* :class:`SimParams` — the flat facade every caller builds;
  :meth:`SimParams.split` gives ``(structure, knobs)`` and
  :func:`merge_params` reassembles the attribute view the stages read
  (:class:`EngineParams`).

Backends (``SimStructure.backend``): ``"eager"`` runs the staged torch tick
(the counterpart of the reference's ``"xla"``), ``"cuda"`` routes the hot
stages through the hand-written CUDA kernel of ``kernels/netsim_tick``
(the counterpart of ``"pallas"``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from ..symphony import SymphonyParams

__all__ = ["SimParams", "SimStructure", "RuntimeKnobs", "SimState",
           "EngineParams", "merge_params", "stack_knobs", "grid_from_params",
           "lanes_of"]


class SimParams(NamedTuple):
    """Flat simulator config (facade; see module docstring for the split)."""
    dt: float = 10e-6
    n_ticks: int = 20_000
    window: int = 48               # max concurrent steps per slot (W)
    mtu: float = 1000.0            # bytes per "packet" (psn unit)
    record_every: int = 20         # metric sampling period (ticks)
    # RED / ECN (bytes)
    red_kmin: float = 50e3
    red_kmax: float = 100e3
    red_pmax: float = 0.2
    # DCQCN-style rate control
    cc_epoch_ticks: int = 5        # 50 us control epoch
    cc_g: float = 1.0 / 16.0
    cc_rai: float = 5e6            # additive increase (bytes/s) = 40 Mb/s
    cc_rhai: float = 25e6          # hyper increase
    cc_fr_stages: int = 5
    cc_min_rate: float = 1.25e5    # 1 Mb/s floor (paper §5 "soft limit")
    # Symphony
    sym_on: bool = False
    sym: SymphonyParams = SymphonyParams()
    sym_win_ticks: int = 10        # T_win = 100 us
    sym_start_tick: int = 0        # late-start experiments (Fig. 4)
    deploy: str = "tor"            # Symphony tier: "tor" | "all" | "spine"
    # Alternatives / knobs
    pq_on: bool = False            # strict-priority for lagging flows (Fig. 5)
    share_policy: str = "proportional"  # proportional | pq | wfq | drr
    per_step_ecmp: bool = True     # re-hash the 5-tuple every step (§4.7)
    backend: str = "eager"         # "eager" staged torch | "cuda" fused kernel
    segsum: str = "scatter"        # only "scatter" is ported so far
    blk: int | None = None         # instance tiling: not ported yet
    tick_window: int = 1           # ticks per kernel launch: not ported yet

    def structure(self) -> "SimStructure":
        return SimStructure(
            dt=self.dt, n_ticks=self.n_ticks, window=self.window,
            mtu=self.mtu, record_every=self.record_every,
            share_policy=self.share_policy, deploy=self.deploy,
            per_step_ecmp=self.per_step_ecmp, backend=self.backend,
            segsum=self.segsum, blk=self.blk, tick_window=self.tick_window)

    def knobs(self) -> "RuntimeKnobs":
        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32)

        def i32(v):
            return torch.tensor(int(v), dtype=torch.int32)

        return RuntimeKnobs(
            red_kmin=f32(self.red_kmin), red_kmax=f32(self.red_kmax),
            red_pmax=f32(self.red_pmax),
            cc_epoch_ticks=i32(self.cc_epoch_ticks), cc_g=f32(self.cc_g),
            cc_rai=f32(self.cc_rai), cc_rhai=f32(self.cc_rhai),
            cc_fr_stages=i32(self.cc_fr_stages),
            cc_min_rate=f32(self.cc_min_rate),
            sym_on=i32(self.sym_on),
            sym=SymphonyParams(*(f32(v) for v in self.sym)),
            sym_win_ticks=i32(self.sym_win_ticks),
            sym_start_tick=i32(self.sym_start_tick),
            pq_on=i32(self.pq_on))

    def split(self) -> tuple["SimStructure", "RuntimeKnobs"]:
        return self.structure(), self.knobs()


class SimStructure(NamedTuple):
    """Shape/control-flow structure: hashable."""
    dt: float = 10e-6
    n_ticks: int = 20_000
    window: int = 48
    mtu: float = 1000.0
    record_every: int = 20
    share_policy: str = "proportional"
    deploy: str = "tor"
    per_step_ecmp: bool = True
    backend: str = "eager"
    segsum: str = "scatter"
    blk: int | None = None
    tick_window: int = 1


class RuntimeKnobs(NamedTuple):
    """Numeric control knobs: float32/int32 tensors, 0-d for one point or
    ``[K]`` for a stacked grid (one entry per lane inside the engine)."""
    red_kmin: torch.Tensor
    red_kmax: torch.Tensor
    red_pmax: torch.Tensor
    cc_epoch_ticks: torch.Tensor
    cc_g: torch.Tensor
    cc_rai: torch.Tensor
    cc_rhai: torch.Tensor
    cc_fr_stages: torch.Tensor
    cc_min_rate: torch.Tensor
    sym_on: torch.Tensor            # 0/1 gate
    sym: SymphonyParams             # five f32 leaves (k, tau, warmup, sample, amax)
    sym_win_ticks: torch.Tensor
    sym_start_tick: torch.Tensor
    pq_on: torch.Tensor             # 0/1 gate: strict-priority override

    def map(self, fn) -> "RuntimeKnobs":
        """Apply ``fn`` to every tensor leaf (the five Symphony leaves too)."""
        d = {f: fn(getattr(self, f)) for f in self._fields if f != "sym"}
        return RuntimeKnobs(sym=SymphonyParams(*(fn(x) for x in self.sym)),
                            **d)


class SimState(NamedTuple):
    """The checkpoint/resume carry of a simulation in flight: the tick
    cursor (a Python int, so the tick loop never waits on the device) and
    the full engine state (``stages.EngineState``, lane axis first,
    including the DCQCN PRNG keys).  Resuming from a ``SimState`` is
    bit-for-bit identical to having never paused."""
    tick: int
    engine: Any


class EngineParams(NamedTuple):
    """Merged view handed to the stages: static fields are Python values,
    knob fields are ``[B]`` tensors on the simulation device.

    ``pq_lanes`` (``"none"|"some"|"all"``), ``cc_periods`` (each lane's
    ``cc_epoch_ticks``) and ``sym_from`` (the first tick at which any lane
    marks with Symphony) are host-side copies of knobs, read once when the
    params are merged, so that the tick loop can skip a share policy, the
    DCQCN draw or the Symphony marking math that no lane uses this tick,
    without syncing on the device.  Skipping changes no result: the
    skipped values would be discarded.
    """
    dt: float
    n_ticks: int
    window: int
    mtu: float
    record_every: int
    share_policy: str
    deploy: str
    per_step_ecmp: bool
    backend: str
    segsum: str
    blk: int | None
    tick_window: int
    red_kmin: torch.Tensor
    red_kmax: torch.Tensor
    red_pmax: torch.Tensor
    cc_epoch_ticks: torch.Tensor
    cc_g: torch.Tensor
    cc_rai: torch.Tensor
    cc_rhai: torch.Tensor
    cc_fr_stages: torch.Tensor
    cc_min_rate: torch.Tensor
    sym_on: torch.Tensor
    sym: SymphonyParams
    sym_win_ticks: torch.Tensor
    sym_start_tick: torch.Tensor
    pq_on: torch.Tensor
    pq_lanes: str = "none"
    cc_periods: tuple = (5,)
    sym_from: int = 0


def lanes_of(knobs: RuntimeKnobs) -> int:
    """Number of lanes a knob pytree carries (1 for a 0-d point)."""
    return 1 if knobs.red_kmin.dim() == 0 else int(knobs.red_kmin.shape[0])


def merge_params(struct: SimStructure, knobs: RuntimeKnobs) -> EngineParams:
    """Static structure + knobs -> the stages' attribute view.  Knobs keep
    their device; 0-d knobs become one-lane ``[1]`` tensors."""
    knobs = knobs.map(lambda x: x.reshape(-1))
    pq = [int(v) != 0 for v in knobs.pq_on.tolist()]
    pq_lanes = "all" if all(pq) else ("some" if any(pq) else "none")
    sym_starts = [int(t) for on, t in zip(knobs.sym_on.tolist(),
                                          knobs.sym_start_tick.tolist())
                  if on]
    return EngineParams(
        dt=struct.dt, n_ticks=struct.n_ticks, window=struct.window,
        mtu=struct.mtu, record_every=struct.record_every,
        share_policy=struct.share_policy, deploy=struct.deploy,
        per_step_ecmp=struct.per_step_ecmp, backend=struct.backend,
        segsum=struct.segsum, blk=struct.blk, tick_window=struct.tick_window,
        pq_lanes=pq_lanes,
        cc_periods=tuple(int(v) for v in knobs.cc_epoch_ticks.tolist()),
        sym_from=min(sym_starts) if sym_starts else 2**31 - 1,
        **knobs._asdict())


def stack_knobs(knobs: Sequence[RuntimeKnobs]) -> RuntimeKnobs:
    """Stack scalar knob pytrees into one grid pytree with leading axis K."""
    if not knobs:
        raise ValueError("empty knob grid")
    first = knobs[0]
    d = {f: torch.stack([getattr(k, f) for k in knobs])
         for f in first._fields if f != "sym"}
    sym = SymphonyParams(*(torch.stack([k.sym[i] for k in knobs])
                           for i in range(len(first.sym))))
    return RuntimeKnobs(sym=sym, **d)


def grid_from_params(cfgs: Sequence[SimParams]
                     ) -> tuple[SimStructure, RuntimeKnobs]:
    """Split a list of SimParams into (shared structure, stacked knobs).

    All cfgs must agree on every structural field — a grid sweeps knob
    values through one structure, it cannot change shapes.
    """
    if not cfgs:
        raise ValueError("empty parameter grid")
    structs = {cfg.structure() for cfg in cfgs}
    if len(structs) > 1:
        a, b, *_ = structs
        diff = [f for f, x, y in zip(a._fields, a, b) if x != y]
        raise ValueError(
            f"grid points differ in static structure (fields {diff}); "
            "sweep only RuntimeKnobs fields, or run separate grids")
    return cfgs[0].structure(), stack_knobs([cfg.knobs() for cfg in cfgs])
