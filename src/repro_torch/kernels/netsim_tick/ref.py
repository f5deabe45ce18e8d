"""Plain torch versions of the netsim tick kernels (the CUDA kernels' oracles).

:func:`hot_tick` computes what ``csrc/netsim_tick.cu`` computes — the
counterpart of the reference's ``kernel.hot_tick`` in ``segsum="scatter"``
mode — batched over a leading lane axis.  It replays the stage functions'
op sequence, with the float segment sums added in ascending entry order
(:func:`~repro_torch.core.netsim.stages.ordered_segment_sum`), so on the
CPU it equals the staged eager tick bit for bit.  The kernel wrapper runs
it for CPU tensors; ``chip_smoke.py`` holds the kernel against it on the
card.

:func:`tiled_tick_ref` is the tiled tick's plain version (the counterpart
of the reference's ``_tiled_tick_kernel``, ``segsum="onehot"`` with
``blk``): the same tick with every float sum taken per ``blk``-instance
block and the block partials folded in ascending block order.

:func:`window_ref` is the multi-tick window kernel's plain version: ``n``
staged eager ticks, returning the last tick's sample.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.netsim.stages import (BIG, WIRE_SEG, div_scalar, ecmp_choice,
                                   ecmp_hash_base, ecmp_routes,
                                   engine_tick_eager, lane_take,
                                   ordered_segment_sum, per_hop,
                                   segment_max_into, segment_min,
                                   symphony_epoch, symphony_rows)


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


def block_partials(rows, R: int, vals, blk: int, H: int) -> torch.Tensor:
    """Per-block partial sums ``[B, NB, R]`` of ``vals`` ``[B, FW*H]`` over
    the (instance, hop) entries whose row is ``rows`` ``[B, FW*H]``: each
    block's entries (``blk`` instances) added in ascending entry order
    from zero."""
    B, E = rows.shape
    FW = E // H
    NB = -(-FW // blk)
    eblk = (torch.arange(FW, device=rows.device) // blk).repeat_interleave(H)
    return ordered_segment_sum(
        torch.zeros(B, NB * R, dtype=torch.float32, device=rows.device),
        eblk * R + rows, vals).reshape(B, NB, R)


def tiled_tick_ref(step, sent, rate, done_upto, q_prev,
                   s_stepmin, s_psnwin, s_alpha, s_cnt, s_cntop,
                   cap, bg_base, bg_amp,
                   inst_job, inst_flow, sps, phase, nph, off, tables,
                   iscal, fscal, *, n_jobs: int, blk: int, dt: float,
                   mtu: float, per_step_ecmp: bool, policy: str,
                   partials: dict | None = None) -> TickOut:
    """One tick over ``blk``-instance blocks; operands as
    ``tiled.netsim_tiled`` documents them.

    The reference's four sweeps compute per-block partials of the link
    loads (proportional, hi and lo class) and of the Symphony ``cnt`` and
    ``cntop`` rows.  Here each partial is the block's entries added in
    ascending (instance, hop) order from zero (:func:`block_partials`), and
    a row's total is its partials added in ascending block order; offered
    loads then add the background and the Symphony rows add the partial
    sum to the state.  Integer reductions (job min-wire, step-min
    candidates) and the psn window (a max) do not depend on the order.
    Route ids, domains and chunk sizes come from the packed per-instance
    tables.  A ``partials`` dict receives, under ``"link_p"``,
    ``"link_hi"``, ``"link_lo"``, ``"cnt"`` and ``"cntop"``, ``(rows,
    values, block partials)``: the entries' rows and values ``[B, FW*H]``
    and their ``[B, NB, R]`` partials; and under ``"active"`` the
    instances' flags ``[B, FW]``."""
    chunk, n_paths = tables.chunk, tables.n_paths
    B, FW = step.shape
    F = done_upto.shape[1]
    W = FW // F
    H = tables.routes.shape[-1]
    SEG = chunk.shape[-1]
    J = int(n_jobs)
    DJ = s_stepmin.shape[1]
    L1 = cap.shape[1]
    blk = min(int(blk), FW)
    NB = -(-FW // blk)
    dev = step.device
    tick, seed, bg_period, sym_win, pq_on = iscal.unbind(1)
    bg_duty, kmin, kmax, pmax, tau, n_sample, alpha_max = fscal.unbind(1)
    job = inst_job.long()

    # ---- instance view (sweep 0 of the reference)
    iseg = torch.div(step, sps, rounding_mode="floor") * nph + phase
    segc = torch.clamp(iseg, 0, SEG - 1).long()
    ichunk = torch.gather(chunk, 2, segc[..., None])[..., 0]
    iwire = iseg * WIRE_SEG + torch.remainder(step, sps) + off
    occupied = step >= 0
    retired = occupied & (step < done_upto.repeat_interleave(W, dim=1))
    complete = occupied & (sent >= ichunk)
    active = occupied & ~complete & ~retired
    ipsn = div_scalar(sent, mtu)
    if per_step_ecmp:
        choice = ecmp_choice(ecmp_hash_base(inst_flow.long(), seed), step,
                             n_paths.long())
        pick = choice[..., None, None].expand(B, FW, 1, H)
        iroute = torch.gather(tables.cand, 2, pick)[:, :, 0]
        idom = torch.gather(tables.cand_dom, 2, pick)[:, :, 0]
    else:
        iroute, idom = tables.routes, tables.route_dom
    iroute_l = iroute.long()
    if partials is not None:
        partials["active"] = active

    def block_sum(rows, R, vals, name):
        """Per-row sums of ``vals`` ``[B, FW*H]`` over the entries whose
        row is ``rows`` ``[B, FW*H]``: block partials folded in order."""
        part = block_partials(rows, R, vals, blk, H)
        if partials is not None:
            partials[name] = (rows, vals, part)
        acc = part[:, 0]
        for b in range(1, NB):
            acc = acc + part[:, b]
        return acc

    flat_links = iroute_l.reshape(B, -1)

    def lsum(vals, name):
        return block_sum(flat_links, L1, per_hop(vals, H), name)

    # ---- sweeps 0-1: link loads of both classes
    bg_on = torch.remainder(tick, bg_period).to(torch.float32) < \
        bg_duty * bg_period.to(torch.float32)
    bg = bg_base + torch.where(bg_on[:, None], bg_amp, 0.0)
    w_rate = torch.where(active, rate, 0.0)
    off_p = lsum(w_rate, "link_p") + bg
    job_min_wire = segment_min(BIG, J, job[None],
                               torch.where(active, iwire, BIG))
    is_hi = active & (iwire <= job_min_wire[:, job])
    off_hi = lsum(torch.where(is_hi, rate, 0.0), "link_hi") + bg
    off_lo = lsum(torch.where(active & ~is_hi, rate, 0.0), "link_lo")

    # ---- sweep 2: link scales, eff, Symphony counters and candidates
    s_l = torch.clamp(cap / torch.clamp(off_p, min=1.0), max=1.0)
    s_hi = torch.clamp(cap / torch.clamp(off_hi, min=1.0), max=1.0)
    rem = torch.clamp(cap - off_hi * s_hi, min=0.0)
    s_lo = rem / torch.clamp(off_lo, min=1.0)
    eff_p = w_rate * lane_take(s_l, iroute_l).amin(dim=2)
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

    dj = idom.long() * J + job[None, :, None]
    djf = dj.reshape(B, -1)
    pkts = div_scalar(eff * dt, mtu)
    done = active & (sent + eff * dt >= ichunk)
    send = active & (eff > 1.0)

    def hops(x):
        return x[..., None].expand(B, FW, H).reshape(B, FW * H)

    pk_act = torch.where(active, pkts, 0.0)
    cnt = s_cnt + block_sum(djf, DJ, hops(pk_act), "cnt")
    over = iwire[..., None] > lane_take(s_stepmin, dj)
    cntop = s_cntop + block_sum(
        djf, DJ, torch.where(over, pk_act[..., None], 0.0).reshape(B, -1),
        "cntop")
    cand_row = segment_max_into(torch.zeros_like(s_stepmin), djf,
                                hops(torch.where(done, iwire + 1, 0)))
    cand_row = torch.maximum(s_stepmin, cand_row)
    min_act = segment_min(BIG, DJ, djf,
                          hops(torch.where(active & ~done, iwire, BIG)))

    # ---- sweep 3: step-min, psn window; then the flush
    stepmin = torch.where(min_act < BIG, torch.minimum(cand_row, min_act),
                          cand_row)
    at_min = iwire[..., None] == lane_take(stepmin, dj)
    psnwin = segment_max_into(
        s_psnwin, djf,
        torch.where(at_min & (send & ~done)[..., None],
                    (ipsn + pkts)[..., None], 0.0).reshape(B, -1))
    q = torch.clamp(q_prev + (offered - cap) * dt, min=0.0)
    q[:, L1 - 1] = 0.0
    p_red = torch.clamp((q - kmin[:, None]) / (kmax - kmin)[:, None],
                        0.0, 1.0) * pmax[:, None]
    s_psnwin, s_alpha, s_cnt, s_cntop = symphony_epoch(
        s_alpha, cnt, cntop, psnwin, torch.remainder(tick, sym_win) ==
        sym_win - 1, n_sample, tau, alpha_max)
    return TickOut(iroute=iroute.to(torch.int32), eff=eff, offered=offered,
                   q=q, p_red=p_red, s_stepmin=stepmin, s_psnwin=s_psnwin,
                   s_alpha=s_alpha, s_cnt=s_cnt, s_cntop=s_cntop)


def window_ref(ctx, cfg, state, base_tick: int, n: int):
    """``n`` staged eager ticks from ``base_tick``: returns ``(state after
    n ticks, metric sample of tick base_tick+n-1)``, the window kernel's
    contract."""
    if n < 1:
        raise ValueError(f"a window runs at least one tick, got n={n}")
    with torch.no_grad():
        for t in range(int(base_tick), int(base_tick) + n):
            state, smp = engine_tick_eager(ctx, cfg, state, t,
                                           sample=t == base_tick + n - 1)
    return state, smp
