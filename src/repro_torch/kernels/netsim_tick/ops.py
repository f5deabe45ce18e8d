"""Engine-facing entry points for the netsim tick kernels.

`stages.engine_tick` dispatches here when ``cfg.backend == "cuda"``:
:func:`engine_tick_fused` runs the hot stages (instance view, route
selection, bandwidth sharing, queue/RED, Symphony update) in the CUDA
kernel of :mod:`.kernel` (with ``segsum="onehot"``: the tiled kernel of
:mod:`.tiled`, over ``blk``-instance blocks or one whole-axis block) and
composes the remaining cheap stages (marking, progress, rate control,
segment barriers, metrics) around it in torch.
With ``tick_window > 1`` the simulator calls :func:`engine_window_fused`
instead, which runs whole ticks, many per launch, in the window kernel of
:mod:`.window`.  On CPU tensors both wrappers run their plain torch
versions; those of the single-tick and window kernels are bit-for-bit
equal to the eager tick, that of the tiled kernel adds its float sums block
by block (``segsum="onehot"``'s allclose contract).
"""
from __future__ import annotations

import torch

from ...core.netsim.stages import (EngineState, instance_view, stage_marking,
                                   stage_metrics, stage_progress,
                                   stage_rate_control, stage_segments,
                                   stage_starts)
from ...core.netsim.params import plan_tiling
from .kernel import TickOut, kernel_policy, netsim_tick
from .tiled import netsim_tiled
from .window import netsim_window

__all__ = ["kernel_policy", "tick_operands", "tiled_operands", "fused_tick",
           "compose_tick", "engine_tick_fused", "engine_window_fused"]


def tick_operands(ctx, cfg, starts, state: EngineState, tick: int
                  ) -> tuple[tuple, dict]:
    """The kernel's operands for this tick: ``(args, kwargs)`` of
    :func:`.kernel.netsim_tick` (and of its plain version)."""
    st, B, FW = ctx.st, ctx.B, ctx.FW
    iscal = torch.stack([
        torch.full((B,), int(tick), dtype=torch.int32, device=ctx.device),
        st.seed, st.bg_period_ticks, cfg.sym_win_ticks, cfg.pq_on],
        dim=1).to(torch.int32)
    fscal = torch.stack([st.bg_duty, cfg.red_kmin, cfg.red_kmax,
                         cfg.red_pmax, cfg.sym.tau, cfg.sym.n_sample,
                         cfg.sym.alpha_max], dim=1).to(torch.float32)
    args = (starts.step_of.reshape(B, FW), starts.sent.reshape(B, FW),
            starts.rate.reshape(B, FW), state.done_upto, state.q,
            state.s_stepmin, state.s_psnwin, state.s_alpha,
            state.s_cnt, state.s_cntop,
            st.routes, st.path_table, st.n_paths, st.cap, st.link_dom,
            st.bg_base, st.bg_amp,
            ctx.inst_job, ctx.inst_flow, ctx.sps_i, ctx.phase_i, ctx.nph_i,
            ctx.off_i, ctx.wl.chunk_sched, iscal, fscal)
    kwargs = dict(dt=cfg.dt, mtu=cfg.mtu, per_step_ecmp=cfg.per_step_ecmp,
                  policy=kernel_policy(cfg))
    return args, kwargs


def tiled_operands(ctx, cfg, starts, state: EngineState, tick: int,
                   blk: int) -> tuple[tuple, dict]:
    """The tiled kernel's operands for this tick: ``(args, kwargs)`` of
    :func:`.tiled.netsim_tiled` (and of its plain version)."""
    (step, sent, rate, done_upto, q, smin, spsn, salpha, scnt, scntop,
     _routes, _paths, _npaths, cap, _dom, bg_base, bg_amp,
     inst_job, inst_flow, sps, phase, nph, off, _chunk, iscal, fscal), kw = \
        tick_operands(ctx, cfg, starts, state, tick)
    args = (step, sent, rate, done_upto, q, smin, spsn, salpha, scnt, scntop,
            cap, bg_base, bg_amp, inst_job, inst_flow, sps, phase, nph, off,
            ctx.tables, iscal, fscal)
    return args, dict(kw, n_jobs=ctx.J, blk=blk)


def fused_tick(ctx, cfg, starts, state: EngineState, tick: int) -> TickOut:
    """Marshal the engine state into the kernel's operands and run it:
    the tiled kernel for ``segsum="onehot"`` (``plan_tiling``'s ``blk``, or
    one block of the whole instance axis), else the single-tick kernel."""
    blk = plan_tiling(ctx.FW, cfg.blk, cfg.segsum, cfg.tick_window)
    if cfg.segsum == "onehot":
        args, kwargs = tiled_operands(ctx, cfg, starts, state, tick,
                                      blk or ctx.FW)
        return netsim_tiled(*args, **kwargs)
    args, kwargs = tick_operands(ctx, cfg, starts, state, tick)
    return netsim_tick(*args, **kwargs)


def compose_tick(ctx, cfg, state: EngineState, tick: int, starts,
                 out: TickOut, sample: bool = True):
    """Compose the cheap stages around the fused hot-path outputs into the
    engine-tick contract ``(state', metric sample)``."""
    inst = instance_view(ctx, starts, state, cfg.mtu, cfg.per_step_ecmp,
                         iroute=out.iroute)
    lam, _pkts, _sm = stage_marking(ctx, cfg, state, inst, out.p_red,
                                    out.eff, starts.lam, tick)
    sent, done_upto, finish, _newly_done = stage_progress(
        ctx, cfg, state, inst, starts.step_of, out.eff, tick)
    rate, target, alpha_cc, stage, lam, key = stage_rate_control(
        ctx, cfg, starts, lam, state.key, tick)
    seg_idx, seg_ready, job_finish = stage_segments(ctx, state, done_upto,
                                                    tick)
    smp = (stage_metrics(ctx, inst, done_upto, out.eff, out.q, out.s_alpha)
           if sample else None)
    new_state = EngineState(
        next_step=starts.next_step, done_upto=done_upto, finish=finish,
        step_of=starts.step_of, sent=sent, rate=rate, target=target,
        alpha_cc=alpha_cc, stage=stage, lam=lam, q=out.q,
        s_stepmin=out.s_stepmin, s_psnwin=out.s_psnwin, s_alpha=out.s_alpha,
        s_cnt=out.s_cnt, s_cntop=out.s_cntop,
        seg_idx=seg_idx, seg_ready=seg_ready, job_finish=job_finish,
        key=key,
    )
    return new_state, smp


def engine_tick_fused(ctx, cfg, state: EngineState, tick: int,
                      sample: bool = True):
    """One tick with the hot stages fused; same contract as
    `stages.engine_tick_eager`: returns ``(state', metric sample)``."""
    starts = stage_starts(ctx, state, tick)
    out = fused_tick(ctx, cfg, starts, state, tick)
    return compose_tick(ctx, cfg, state, tick, starts, out, sample)


def engine_window_fused(ctx, cfg, state: EngineState, base_tick: int,
                        n: int):
    """Run ``n`` consecutive ticks from ``base_tick`` in ONE launch of the
    window kernel: start gating, the hot stages, marking, progress, rate
    control, segments and the last tick's metrics.  Returns ``(state after
    n ticks, metric sample of the last tick)``."""
    plan_tiling(ctx.FW, cfg.blk, cfg.segsum, cfg.tick_window)
    return netsim_window(ctx, cfg, state, base_tick, n)
