"""Engine-facing entry points for the fused netsim tick kernel.

`stages.engine_tick` dispatches here when ``cfg.backend == "cuda"``:
:func:`engine_tick_fused` runs the hot stages (instance view, route
selection, bandwidth sharing, queue/RED, Symphony update) in the CUDA
kernel of :mod:`.kernel` and composes the remaining cheap stages (marking,
progress, rate control, segment barriers, metrics) around it in torch.
On CPU tensors the kernel wrapper runs its plain torch version, which is
bit-for-bit equal to the eager tick.
"""
from __future__ import annotations

import torch

from ...core.netsim.stages import (EngineState, instance_view, stage_marking,
                                   stage_metrics, stage_progress,
                                   stage_rate_control, stage_segments,
                                   stage_starts)
from .kernel import TickOut, netsim_tick

__all__ = ["kernel_policy", "tick_operands", "fused_tick", "compose_tick",
           "engine_tick_fused"]


def kernel_policy(cfg) -> str:
    """The in-kernel share policy for this config ("proportional"|"pq")."""
    if cfg.share_policy == "pq" or cfg.pq_lanes == "all":
        return "pq"
    return "proportional"


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


def fused_tick(ctx, cfg, starts, state: EngineState, tick: int) -> TickOut:
    """Marshal the engine state into the kernel's operands and run it."""
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
