"""Post-processing of SimResult into the paper's metrics (numpy, host-side).

Counterpart of ``repro.core.netsim.metrics``: the same functions, reading
the port's results (torch tensors on any device) as numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .params import SimParams
from .simulator import SimResult
from .stages import I32MAX
from .workload import Workload


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def overlap_series(res: SimResult, cfg: SimParams, job: int = 0):
    """Degree of step overlap over time (Fig. 2a / 4a): number of distinct
    steps concurrently in flight. Returns (t_seconds, overlap)."""
    mn = _np(res.ts_min_wire)[..., job].astype(np.int64)
    mx = _np(res.ts_max_wire)[..., job].astype(np.int64)
    has = mx >= 0
    # Within a segment, wire differences equal step differences; the job-wide
    # barrier guarantees no cross-segment concurrency, so this is exact.
    ov = np.where(has, mx - mn + 1, 0)
    t = (np.arange(mn.shape[-1]) + 1.0) * cfg.record_every * cfg.dt
    return t, ov


def step_completion_times(res: SimResult, cfg: SimParams, job: int = 0):
    """Times (s) at which the job-wide min completed-step counter advanced."""
    dm = _np(res.ts_done_min)[..., job]
    t = (np.arange(dm.shape[-1]) + 1.0) * cfg.record_every * cfg.dt
    times = []
    last = 0
    for i, v in enumerate(dm):
        v = int(v)
        while last < v:
            last += 1
            times.append(t[i])
    return np.asarray(times)


def step_completion_rate(res: SimResult, cfg: SimParams, job: int = 0,
                         smooth: int = 4):
    """Normalized step completion rate (Fig. 2b): inverse inter-step interval,
    normalized by the ideal per-step time."""
    times = step_completion_times(res, cfg, job)
    if len(times) < 2 + smooth:
        return np.asarray([]), np.asarray([])
    iv = np.diff(times)
    iv = np.convolve(iv, np.ones(smooth) / smooth, mode="valid")
    rate = 1.0 / np.maximum(iv, 1e-9)
    return times[1 + smooth - 1:], rate


def cct_seconds(res: SimResult, wl: Workload, cfg: SimParams) -> np.ndarray:
    """Per-job collective/job completion time (finish - start), seconds.
    Works on batched results (leading seed axes)."""
    jf = _np(res.job_finish_ticks).astype(np.float64)
    start = np.asarray(wl.start_time) / cfg.dt
    out = (jf - start) * cfg.dt
    return np.where(jf >= I32MAX, np.nan, out)


def flow_span_seconds(res: SimResult, wl: Workload, cfg: SimParams,
                      job: int = 0) -> np.ndarray:
    """Span of the final collective step: completion-time spread between the
    fastest and slowest flow of a job (Fig. 7b)."""
    ft = _np(res.finish_ticks).astype(np.float64)
    mask = np.asarray(wl.job) == job
    sel = ft[..., mask]
    return (sel.max(axis=-1) - sel.min(axis=-1)) * cfg.dt


def ideal_cct(wl: Workload, job: int, link_bps: float) -> float:
    """Theoretical lockstep lower bound: every step takes chunk/bandwidth,
    steps are serial, plus compute gaps.  Handles multi-phase collectives
    (2-D rings, halving-doubling, hierarchical) whose phases run different
    step counts: segment k serializes the max step count among the flows
    participating in phase k % n_phases."""
    jmask = np.asarray(wl.job) == job
    sps_f = np.asarray(wl.steps_per_seg)[jmask]
    phase_f = np.asarray(wl.phase)[jmask]
    passes = int(np.asarray(wl.n_passes)[job])
    nph = int(np.asarray(wl.n_phases)[job])
    phase_sps = np.asarray([sps_f[phase_f == q].max() for q in range(nph)])
    per_seg = np.asarray(wl.chunk_sched)[job, :passes * nph]
    seg_sps = phase_sps[np.arange(passes * nph) % nph]
    comm = float(np.sum(per_seg * seg_sps / link_bps))
    return comm + passes * float(np.asarray(wl.compute_gap)[job])


def max_overlap(res: SimResult, cfg: SimParams, job: int = 0):
    """Maximum step-overlap over the run (supports batched results)."""
    _, ov = overlap_series(res, cfg, job)
    return ov.max(axis=-1)


# --------------------------------------------- online control-plane summaries
class WindowStats(NamedTuple):
    """Host-side summary of one control window's sampled series — the
    observation an online tuner reacts to (``control.SimController``)."""
    alpha_max: float         # max Symphony alpha over the window
    alpha_last: float        # alpha at the window's final sample
    qmax: float              # max queue depth (bytes) over the window
    q_last: float            # queue depth at the final sample
    tput: np.ndarray         # [J] window-mean delivered bytes/s per job
    tput_last: np.ndarray    # [J] delivered bytes/s at the final sample
    done_min: np.ndarray     # [J] min completed local steps (final sample)
    overlap: np.ndarray      # [J] in-flight wire-step span (final sample)


def window_summary(samples) -> WindowStats:
    """Reduce a :class:`~repro.core.netsim.simulator.WindowSamples` (or any
    SimResult-shaped series bundle) to one :class:`WindowStats`."""
    mn = _np(samples.ts_min_wire)[-1].astype(np.int64)
    mx = _np(samples.ts_max_wire)[-1].astype(np.int64)
    tput = _np(samples.ts_throughput)
    q = _np(samples.ts_qmax)
    al = _np(samples.ts_alpha_max)
    return WindowStats(
        alpha_max=float(al.max()),
        alpha_last=float(al[-1]),
        qmax=float(q.max()),
        q_last=float(q[-1]),
        tput=tput.mean(axis=0),
        tput_last=tput[-1],
        done_min=_np(samples.ts_done_min)[-1],
        overlap=np.where(mx >= 0, mx - mn + 1, 0),
    )
