"""Plain torch version of the fused netsim tick (the CUDA kernel's oracle).

:func:`hot_tick` computes what ``csrc/netsim_tick.cu`` computes — the
counterpart of the reference's ``kernel.hot_tick`` in ``segsum="scatter"``
mode — batched over a leading lane axis.  It replays the stage functions'
op sequence, with the float segment sums added in ascending entry order
(:func:`~repro_torch.core.netsim.stages.ordered_segment_sum`), so on the
CPU it equals the staged eager tick bit for bit.  The kernel wrapper runs
it for CPU tensors; ``chip_smoke.py`` holds the kernel against it on the
card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.netsim.stages import (BIG, WIRE_SEG, div_scalar, ecmp_routes,
                                   lane_take, ordered_segment_sum, per_hop,
                                   segment_min, symphony_epoch,
                                   symphony_rows)


class TickOut(NamedTuple):
    """Fused-tick outputs, lane axis first."""
    iroute: torch.Tensor     # [B, FW, H] i32 selected per-instance routes
    eff: torch.Tensor        # [B, FW]    delivered bytes/s per instance
    offered: torch.Tensor    # [B, L+1]   offered load per link
    q: torch.Tensor          # [B, L+1]   integrated queues
    p_red: torch.Tensor      # [B, L+1]   RED marking profile
    s_stepmin: torch.Tensor  # [B, DJ] i32 Symphony state block (post-update)
    s_psnwin: torch.Tensor
    s_alpha: torch.Tensor
    s_cnt: torch.Tensor
    s_cntop: torch.Tensor


def hot_tick(step, sent, rate, done_upto, q_prev,
             s_stepmin, s_psnwin, s_alpha, s_cnt, s_cntop,
             routes, path_table, n_paths, cap, link_dom, bg_base, bg_amp,
             inst_job, inst_flow, sps, phase, nph, off, chunk_sched,
             iscal, fscal, *, dt: float, mtu: float, per_step_ecmp: bool,
             policy: str) -> TickOut:
    """One fused tick on plain tensors; operands as ``kernel.netsim_tick``
    documents them."""
    B, FW = step.shape
    H = routes.shape[-1]
    J, SEG = chunk_sched.shape
    DJ = s_stepmin.shape[1]
    L1 = cap.shape[1]
    tick, seed, bg_period, sym_win, pq_on = iscal.unbind(1)
    bg_duty, kmin, kmax, pmax, tau, n_sample, alpha_max = fscal.unbind(1)
    job = inst_job.long()
    flow = inst_flow.long()

    # ---- instance view
    iseg = torch.div(step, sps, rounding_mode="floor") * nph + phase
    ichunk = chunk_sched[job, torch.clamp(iseg, 0, SEG - 1)]
    iwire = iseg * WIRE_SEG + torch.remainder(step, sps) + off
    occupied = step >= 0
    retired = occupied & (step < done_upto[:, flow])
    complete = occupied & (sent >= ichunk)
    active = occupied & ~complete & ~retired
    ipsn = div_scalar(sent, mtu)

    # ---- route selection
    if per_step_ecmp:
        iroute = ecmp_routes(path_table, n_paths, seed, flow, step)
    else:
        iroute = routes[:, flow]
    iroute_l = iroute.long()
    flat_links = iroute_l.reshape(B, -1)
    idom = lane_take(link_dom, iroute_l)
    zero_l = torch.zeros(B, L1, dtype=torch.float32, device=step.device)

    def lsum(vals):
        return ordered_segment_sum(zero_l, flat_links, per_hop(vals, H))

    # ---- bandwidth sharing (proportional and strict priority)
    bg_on = torch.remainder(tick, bg_period).to(torch.float32) < \
        bg_duty * bg_period.to(torch.float32)
    bg = bg_base + torch.where(bg_on[:, None], bg_amp, 0.0)
    w_rate = torch.where(active, rate, 0.0)

    off_p = lsum(w_rate) + bg
    s_l = torch.clamp(cap / torch.clamp(off_p, min=1.0), max=1.0)
    eff_p = w_rate * lane_take(s_l, iroute_l).amin(dim=2)

    job_min_wire = segment_min(BIG, J, job[None],
                               torch.where(active, iwire, BIG))
    is_hi = active & (iwire <= job_min_wire[:, job])
    off_hi = lsum(torch.where(is_hi, rate, 0.0)) + bg
    s_hi = torch.clamp(cap / torch.clamp(off_hi, min=1.0), max=1.0)
    rem = torch.clamp(cap - off_hi * s_hi, min=0.0)
    off_lo = lsum(torch.where(active & ~is_hi, rate, 0.0))
    s_lo = rem / torch.clamp(off_lo, min=1.0)
    share = torch.where(is_hi[..., None], lane_take(s_hi, iroute_l),
                        torch.clamp(lane_take(s_lo, iroute_l), max=1.0))
    eff_q = w_rate * share.amin(dim=2)
    off_q = off_hi + off_lo

    if policy == "pq":
        eff, offered = eff_q, off_q
    else:
        gate = (pq_on != 0)[:, None]
        eff = torch.where(gate, eff_q, eff_p)
        offered = torch.where(gate, off_q, off_p)

    # ---- queues + RED
    q = torch.clamp(q_prev + (offered - cap) * dt, min=0.0)
    q[:, L1 - 1] = 0.0
    p_red = torch.clamp((q - kmin[:, None]) / (kmax - kmin)[:, None],
                        0.0, 1.0) * pmax[:, None]

    # ---- Symphony per-(domain, job) update
    dj = idom.long() * J + job[None, :, None]
    pkts = div_scalar(eff * dt, mtu)
    newly_done = active & (sent + eff * dt >= ichunk)
    cnt, cntop, stepmin, psnwin = symphony_rows(
        s_stepmin, s_psnwin, s_cnt, s_cntop, dj.reshape(B, -1),
        lane_take(s_stepmin, dj), active, newly_done, active & (eff > 1.0),
        iwire, ipsn, pkts)

    s_psnwin, s_alpha, s_cnt, s_cntop = symphony_epoch(
        s_alpha, cnt, cntop, psnwin, torch.remainder(tick, sym_win) ==
        sym_win - 1, n_sample, tau, alpha_max)
    return TickOut(iroute=iroute.to(torch.int32), eff=eff, offered=offered,
                   q=q, p_red=p_red, s_stepmin=stepmin, s_psnwin=s_psnwin,
                   s_alpha=s_alpha, s_cnt=s_cnt, s_cntop=s_cntop)
