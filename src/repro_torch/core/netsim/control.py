"""Online control plane: a ``step(action) -> (state, obs)`` API, in torch.

Counterpart of ``repro.core.netsim.control``.  :class:`SimController` owns a
checkpointable :class:`~repro_torch.core.netsim.params.SimState`, advances
it one *control window* at a time through
:func:`~repro_torch.core.netsim.simulator.run_window`, and lets every window
retune :class:`~repro_torch.core.netsim.params.RuntimeKnobs` fields via
:func:`apply_action`.  Knobs are per-lane tensors, so a retune changes
values only; with ``backend="cuda"`` and ``tick_window > 1`` each record
period runs in window-kernel launches on the card::

    ctl = SimController(topo, wl, cfg, window_ticks=640, seed=3)
    state, obs = ctl.step()                      # run one window
    while not obs.done:
        state, obs = ctl.step({"tau": policy(obs), "k": 0.02})

``obs`` carries the per-window alpha/queue/throughput summaries of
:mod:`.metrics` plus job-completion flags; :meth:`SimController.checkpoint`
takes a CPU snapshot and :meth:`SimController.restore` rewinds to one —
resuming is bit-for-bit identical to never having paused.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ...device import resolve_device
from . import metrics, prng
from .params import RuntimeKnobs, SimParams, SimState, SimStructure
from .simulator import (Static, WindowSamples, _resolve_routing, build_static,
                        init_state, run_window, wl_arrays)
from .stages import I32MAX, EngineState
from .topology import Topology
from .workload import Workload

__all__ = ["ACTION_FIELDS", "StepObs", "SimController", "apply_action"]

# Symphony shortcuts: action keys rewriting knobs.sym.<field>.  Every
# top-level RuntimeKnobs field name (red_pmax, cc_g, sym_on, pq_on,
# sym_win_ticks, ...) is also a valid action key.
_SYM_FIELDS = ("k", "tau", "n_warmup", "n_sample", "alpha_max")
ACTION_FIELDS = tuple(f for f in RuntimeKnobs._fields if f != "sym") \
    + _SYM_FIELDS


def apply_action(knobs: RuntimeKnobs, action: Mapping[str, float]
                 ) -> RuntimeKnobs:
    """Retune knob values from an action dict.

    Keys are top-level :class:`RuntimeKnobs` fields (``"red_pmax"``,
    ``"sym_on"``, ``"sym_win_ticks"``, ...) or Symphony shortcuts
    (``"tau"``, ``"k"``, ``"alpha_max"``, ``"n_warmup"``, ``"n_sample"``)
    that rewrite ``knobs.sym``.  Each new value takes the dtype, shape and
    device of the tensor it replaces (a scalar fills every lane).
    """
    sym_upd: dict = {}
    top: dict = {}
    for name, val in action.items():
        if name in _SYM_FIELDS:
            sym_upd[name] = val
        elif name == "sym":
            raise ValueError(
                "set Symphony fields individually (tau/k/alpha_max/"
                "n_warmup/n_sample), not the whole 'sym' bundle")
        elif name in RuntimeKnobs._fields:
            top[name] = val
        else:
            raise ValueError(
                f"unknown action field {name!r}; have {ACTION_FIELDS}")

    def cast(old: torch.Tensor, new) -> torch.Tensor:
        t = torch.as_tensor(new, dtype=old.dtype, device=old.device)
        return t.expand(old.shape).clone() if t.shape != old.shape else t

    sym = knobs.sym
    if sym_upd:
        sym = sym._replace(**{k: cast(getattr(sym, k), v)
                              for k, v in sym_upd.items()})
    return knobs._replace(
        sym=sym, **{k: cast(getattr(knobs, k), v) for k, v in top.items()})


class StepObs(NamedTuple):
    """What one control window observed (host-side numpy)."""
    tick: int                      # tick cursor AFTER this window
    t: float                       # same, in simulated seconds
    stats: metrics.WindowStats     # alpha/queue/throughput summaries
    samples: WindowSamples         # the window's raw sampled series
    job_finished: np.ndarray       # [J] bool
    done: bool                     # every job finished


class SimController:
    """Stateful windowed driver over ``init_state`` / ``run_window``.

    Owns the :class:`Static` arrays, the current :class:`RuntimeKnobs` and
    the resumable :class:`SimState` (engine arrays with a lane axis of 1),
    all on ``device`` (``None``: the CUDA card; raises without one).  Every
    :meth:`step` advances one control window and returns ``(state, obs)``.
    """

    def __init__(self, topo: Topology, wl: Workload, cfg: SimParams,
                 *, window_ticks: int | None = None, routing: str = "ecmp",
                 seed: int = 0, bg_base=None, bg_amp=None, bg_period=1e-3,
                 bg_duty=0.0, job_weight=None, device=None):
        self.device = resolve_device(device)
        cfg, mode = _resolve_routing(cfg, routing)
        if isinstance(cfg, SimParams):
            struct, knobs = cfg.split()
        else:                         # a SimStructure: default knob values
            struct, knobs = cfg, SimParams().knobs()
        R = struct.record_every
        w = R if window_ticks is None else int(window_ticks)
        if w <= 0 or w % R:
            raise ValueError(
                f"window_ticks must be a positive multiple of "
                f"record_every={R}, got {window_ticks}")
        self.struct: SimStructure = struct
        self.knobs: RuntimeKnobs = knobs.map(lambda x: x.to(self.device))
        self.wl = wl
        self.st: Static = build_static(
            topo, wl, mode, seed, bg_base, bg_amp, bg_period, bg_duty,
            struct.dt, deploy=struct.deploy, job_weight=job_weight,
            device=self.device)
        self.wla = wl_arrays(wl, struct.dt, self.device)
        self.window_ticks = w
        self._seed = seed
        self.state: SimState = self._initial_state()

    def _initial_state(self) -> SimState:
        return init_state(self.st, self.wla, self.struct,
                          prng.prng_key(self._seed, self.device))

    # ------------------------------------------------------------- control
    def step(self, action: Mapping[str, float] | None = None,
             n_ticks: int | None = None) -> tuple[SimState, StepObs]:
        """Apply ``action`` (optional knob retunes), run one window."""
        if action:
            self.knobs = apply_action(self.knobs, action)
        self.state, samples = run_window(
            self.st, self.wla, self.struct, self.knobs, self.state,
            self.window_ticks if n_ticks is None else n_ticks)
        finished = self.state.engine.job_finish[0].cpu().numpy() != I32MAX
        tick = int(self.state.tick)
        obs = StepObs(
            tick=tick, t=tick * self.struct.dt,
            stats=metrics.window_summary(samples), samples=samples,
            job_finished=finished, done=bool(finished.all()))
        return self.state, obs

    def run(self, n_windows: int, policy=None) -> StepObs:
        """Convenience driver: ``n_windows`` steps (or until done);
        ``policy(obs) -> action|None`` is consulted after each window."""
        obs = None
        action = None
        for _ in range(n_windows):
            _, obs = self.step(action)
            if obs.done:
                break
            action = policy(obs) if policy is not None else None
        return obs

    # ---------------------------------------------------- checkpoint/resume
    def checkpoint(self) -> SimState:
        """A detached CPU copy of the current state."""
        return SimState(tick=int(self.state.tick), engine=EngineState(
            *(x.detach().to("cpu", copy=True) for x in self.state.engine)))

    def restore(self, state: SimState) -> None:
        """Rewind (or jump) to a checkpointed state, copied onto this
        controller's device."""
        self.state = SimState(tick=int(state.tick), engine=EngineState(
            *(x.to(self.device, copy=True) for x in state.engine)))

    def reset(self, seed: int | None = None) -> SimState:
        """Back to tick 0 (optionally reseeding the CC coin flips)."""
        if seed is not None:
            self._seed = seed
        self.state = self._initial_state()
        return self.state
