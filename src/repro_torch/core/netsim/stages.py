"""Composable per-tick stages of the fluid network-simulation engine, in torch.

Counterpart of ``repro.core.netsim.stages``.  Every stage carries a leading
*lane* axis ``B`` — the reference's ``vmap`` written out — so one call
advances ``B`` independent simulations (seeds and knob points), and a
single run is ``B == 1``.  The workload arrays (``WLArrays``) are shared by
all lanes; the per-run device arrays (``Static``) and the knobs have one
row per lane.

Stage order (one tick):

1. :func:`stage_starts`        — segment barrier + ring dependency gating
2. :func:`instance_view`       — per-instance arrays incl. route selection
3. :func:`stage_share`         — ``proportional`` / ``pq`` / ``wfq`` /
                                 ``drr`` bandwidth sharing, with the per-lane
                                 ``pq_on`` gate
4. :func:`stage_queues`        — queue integration + RED profile
5. :func:`stage_marking`       — RED x Symphony selective marking -> lambda
6. :func:`stage_progress`      — byte progress, completions, finish times
7. :func:`stage_symphony`      — per-(domain, job) state block updates
8. :func:`stage_rate_control`  — DCQCN-style epoch update
9. :func:`stage_segments`      — segment barriers and job finish
10. :func:`stage_metrics`      — sampled observables

The reference's ``lax.cond`` on the CC epoch and on ``pq_on`` become
per-lane ``torch.where`` selects.  The tick index is a Python int, and
nothing in a tick waits on the device.

Float segment sums (``.at[].add`` in the reference) go through
:func:`ordered_segment_sum`, which adds in ascending entry order — the
order of XLA's CPU scatter — on every device.  ``index_add_`` on a CUDA
tensor accumulates with atomics in an order that changes from run to run,
so it is used only on the CPU.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..symphony import SymphonyParams, marking_probability
from . import prng
from .params import PackedTables, pack_lane_tables

# Wire-step encoding: global segment index * WIRE_SEG + step-within-segment.
WIRE_SEG = 4096
I32MAX = int(np.iinfo(np.int32).max)
BIG = 2**30
_M32 = 0xFFFFFFFF


class WLArrays(NamedTuple):
    """Workload arrays, shared by every lane: ``[F]`` per flow slot and
    ``[J]`` per job (int32), ``chunk_sched`` ``[J, SEG]`` float32."""
    src: torch.Tensor; dst: torch.Tensor; pred: torch.Tensor
    job: torch.Tensor
    phase: torch.Tensor; sps: torch.Tensor; pass_steps: torch.Tensor
    total_steps: torch.Tensor
    n_phases: torch.Tensor; n_segs: torch.Tensor; chunk_sched: torch.Tensor
    gap_ticks: torch.Tensor; start_ticks: torch.Tensor
    step_offset: torch.Tensor; fstart_ticks: torch.Tensor
    trig_job: torch.Tensor; trig_seg: torch.Tensor
    trig_delay_ticks: torch.Tensor


class EngineState(NamedTuple):
    """The tick carry, lane axis first: slot ``[B, F]``, instance
    ``[B, F, W]``, link ``[B, L+1]``, Symphony ``[B, (D+1)*J]``, job
    ``[B, J]`` state and the DCQCN PRNG keys ``[B, 2]``."""
    next_step: torch.Tensor; done_upto: torch.Tensor; finish: torch.Tensor
    step_of: torch.Tensor; sent: torch.Tensor
    rate: torch.Tensor; target: torch.Tensor; alpha_cc: torch.Tensor
    stage: torch.Tensor
    lam: torch.Tensor
    q: torch.Tensor
    s_stepmin: torch.Tensor; s_psnwin: torch.Tensor; s_alpha: torch.Tensor
    s_cnt: torch.Tensor; s_cntop: torch.Tensor
    seg_idx: torch.Tensor; seg_ready: torch.Tensor; job_finish: torch.Tensor
    key: torch.Tensor


@dataclass(frozen=True)
class EngineCtx:
    """Per-run context: dims, lane-batched static arrays, index views.

    Index tensors used for gathers are int64 (``*_l``); value tensors keep
    the reference's int32."""
    st: Any                  # simulator.Static, lane axis first
    wl: WLArrays
    B: int; F: int; J: int; W: int; L: int; H: int; D: int
    device: torch.device
    job_l: torch.Tensor      # [F]  int64
    pred_l: torch.Tensor     # [F]  int64
    nph_f: torch.Tensor      # [F]  phases per pass of each flow's job
    line_rate: torch.Tensor  # [B, F] access-link rate
    inst_job: torch.Tensor   # [FW] int32
    inst_flow: torch.Tensor  # [FW] int32
    inst_job_l: torch.Tensor   # [FW] int64
    inst_flow_l: torch.Tensor  # [FW] int64
    sps_i: torch.Tensor; phase_i: torch.Tensor; nph_i: torch.Tensor
    off_i: torch.Tensor      # [FW] int32
    iroute_static: torch.Tensor  # [B, FW, H] int64
    ecmp_base: torch.Tensor      # [B, FW] per-run part of the ECMP hash
    n_paths_i: torch.Tensor      # [B, FW] int64 candidate paths per instance
    path_row0: torch.Tensor      # [FW] int64 first candidate row, flow * P
    path_flat: torch.Tensor      # [B, F*P, H] int64 candidate paths

    @property
    def FW(self) -> int:
        return self.F * self.W

    @property
    def DJ(self) -> int:
        return (self.D + 1) * self.J

    @cached_property
    def tables(self) -> PackedTables:
        """The lane-batched packed route tables (``[B, FW, ...]``) the
        tiled tick reads; built on first use and kept for the run."""
        return pack_lane_tables(self.st, self.wl, self.W)

    def chunk_of(self, job_ids: torch.Tensor, seg: torch.Tensor
                 ) -> torch.Tensor:
        max_seg = int(self.wl.chunk_sched.shape[1])
        return self.wl.chunk_sched[job_ids, torch.clamp(seg, 0, max_seg - 1)]


def make_ctx(st, wl: WLArrays, window: int) -> EngineCtx:
    B = int(st.cap.shape[0])
    F = int(wl.src.shape[0])
    J = int(wl.n_phases.shape[0])
    W = int(window)
    L = int(st.cap.shape[1]) - 1
    H = int(st.routes.shape[-1])
    P = int(st.path_table.shape[2])
    D = int(st.dom_pad.shape[-1]) - 1
    dev = st.cap.device
    job_l = wl.job.long()
    nph_f = wl.n_phases[job_l]
    fidx = torch.arange(F, device=dev)

    def per_inst(x):
        return x.repeat_interleave(W)

    line_rate = torch.gather(st.cap, 1, st.routes[:, :, 0].long())
    return EngineCtx(
        st=st, wl=wl, B=B, F=F, J=J, W=W, L=L, H=H, D=D, device=dev,
        job_l=job_l, pred_l=wl.pred.long(), nph_f=nph_f,
        line_rate=line_rate,
        inst_job=per_inst(wl.job), inst_flow=per_inst(fidx.to(torch.int32)),
        inst_job_l=per_inst(job_l), inst_flow_l=per_inst(fidx),
        sps_i=per_inst(wl.sps), phase_i=per_inst(wl.phase),
        nph_i=per_inst(nph_f), off_i=per_inst(wl.step_offset),
        iroute_static=st.routes.long().repeat_interleave(W, dim=1),
        ecmp_base=ecmp_hash_base(per_inst(fidx), st.seed),
        n_paths_i=st.n_paths.long().repeat_interleave(W, dim=1),
        path_row0=per_inst(fidx) * P,
        path_flat=st.path_table.long().reshape(B, F * P, H),
    )


def init_state(ctx: EngineCtx, key: torch.Tensor) -> EngineState:
    """Tick-0 state of every lane; ``key`` is ``[B, 2]`` (prng keys)."""
    B, F, W, J, L = ctx.B, ctx.F, ctx.W, ctx.J, ctx.L
    DJ = ctx.DJ
    wl, dev = ctx.wl, ctx.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lr = ctx.line_rate[:, :, None].expand(B, F, W)
    seg_ready = torch.where(wl.trig_job >= 0, I32MAX,
                            wl.start_ticks + wl.gap_ticks)
    return EngineState(
        next_step=torch.zeros(B, F, **i32),
        done_upto=torch.zeros(B, F, **i32),
        finish=torch.full((B, F), I32MAX, **i32),
        step_of=torch.full((B, F, W), -1, **i32),
        sent=torch.zeros(B, F, W, **f32),
        rate=lr.contiguous(),
        target=lr.contiguous(),
        alpha_cc=torch.ones(B, F, W, **f32),
        stage=torch.zeros(B, F, W, **i32),
        lam=torch.zeros(B, F, W, **f32),
        q=torch.zeros(B, L + 1, **f32),
        s_stepmin=torch.zeros(B, DJ, **i32),
        s_psnwin=torch.zeros(B, DJ, **f32),
        s_alpha=torch.ones(B, DJ, **f32),
        s_cnt=torch.zeros(B, DJ, **f32),
        s_cntop=torch.zeros(B, DJ, **f32),
        seg_idx=torch.zeros(B, J, **i32),
        seg_ready=seg_ready.to(torch.int32)[None].expand(B, J).contiguous(),
        job_finish=torch.full((B, J), I32MAX, **i32),
        key=key.to(device=dev, dtype=torch.int64).reshape(B, 2),
    )


def seg_global(c, sps, phase, n_phases):
    """Global segment index of local step c for a flow slot."""
    return torch.div(c, sps, rounding_mode="floor") * n_phases + phase


def wire_step(c, sps, phase, n_phases):
    """Monotone wire-step encoding (§3.2) of local step c."""
    return seg_global(c, sps, phase, n_phases) * WIRE_SEG + \
        torch.remainder(c, sps)


# ------------------------------------------------------ lane-batched helpers
def lane_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather ``x[b, idx[b, ...]]`` for ``x`` ``[B, N]``."""
    B = x.shape[0]
    return torch.gather(x, 1, idx.reshape(B, -1)).reshape(idx.shape)


def ordered_segment_sum(base: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].add(vals)`` per lane, adding in ascending entry order.

    ``base`` is ``[B, R]``, ``idx``/``vals`` are ``[B, E]``.  Each row ends
    as ``((base + v_first) + ...) + v_last`` over its entries in index
    order, which is what XLA's CPU scatter and ``np.add.at`` compute.

    On the CPU this is ``index_add_``, which walks the entries in order.
    On CUDA ``index_add_`` uses atomics, so the entries are instead sorted
    stably by row (with each row's base value placed first) and folded by
    ``segment_reduce``, whose CUDA kernel walks each segment in order with
    one thread.
    """
    B, R = base.shape
    if B == 1:
        flat = idx.reshape(-1)
    else:
        flat = (idx + torch.arange(B, device=base.device)[:, None] * R
                ).reshape(-1)
    if base.device.type == "cpu":
        out = base.reshape(-1).clone()
        out.index_add_(0, flat, vals.reshape(-1).to(base.dtype))
        return out.reshape(B, R)
    keys = torch.cat([torch.arange(B * R, device=base.device), flat])
    allv = torch.cat([base.reshape(-1), vals.reshape(-1).to(base.dtype)])
    order = torch.sort(keys, stable=True).indices
    # per-row counts without bincount, which reads its maximum on the host
    lengths = torch.zeros(B * R, dtype=torch.int64, device=base.device)
    lengths.scatter_add_(0, keys, torch.ones_like(keys))
    out = torch.segment_reduce(allv[order].unsqueeze(1), "sum",
                               lengths=lengths, axis=0, initial=0.0,
                               unsafe=True)
    return out.reshape(B, R)


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE float32 division on every device.  torch's CUDA
    kernel divides by a Python scalar as a multiplication by its
    reciprocal, which rounds differently from the CPU, the reference and
    the CUDA kernel; a divisor tensor on the device keeps true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def segment_min(base_value: int, n_rows: int, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``full(n_rows, base).at[idx].min(vals)`` per lane (integers: any
    order gives the same result)."""
    B = vals.shape[0]
    out = torch.full((B, n_rows), base_value, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(1, idx.expand(B, -1), vals, "amin",
                               include_self=True)


def segment_max_into(base: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].max(vals)`` per lane (order-free)."""
    B = vals.shape[0]
    return base.clone().scatter_reduce_(1, idx.expand(B, -1), vals, "amax",
                                        include_self=True)


def per_hop(x: torch.Tensor, H: int) -> torch.Tensor:
    """``[B, FW]`` -> ``[B, FW*H]``, aligned with ``InstView.flat_links``."""
    return x.repeat_interleave(H, dim=1)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for ``a`` in ``[0, 2**32)`` held in int64,
    split so that no intermediate leaves int64."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def log1p_neg(p: torch.Tensor) -> torch.Tensor:
    """``log1p(-p)``.  Most hops carry no mark probability, and the CPU
    ``log1p`` is slow, so on the CPU it runs on the nonzero entries only
    (``log1p(-0.0)`` is ``-0.0``, which the fill reproduces)."""
    if p.device.type != "cpu":
        return torch.log1p(-p)
    out = torch.full_like(p, -0.0)
    nz = p != 0
    out[nz] = torch.log1p(-p[nz])
    return out


def _knob(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``[B]`` knob shaped to broadcast over ``ndim`` trailing axes."""
    return x.reshape((-1,) + (1,) * ndim)


# ------------------------------------------------------------- 1. starts
class Starts(NamedTuple):
    next_step: torch.Tensor
    step_of: torch.Tensor; sent: torch.Tensor
    rate: torch.Tensor; target: torch.Tensor; alpha_cc: torch.Tensor
    stage: torch.Tensor; lam: torch.Tensor
    can: torch.Tensor


def stage_starts(ctx: EngineCtx, state: EngineState, tick: int) -> Starts:
    """Gate new step-sends on segment barrier + ring data dependency + slot
    availability, and initialize the window slots of the started steps."""
    wl, W = ctx.wl, ctx.W
    job, pred = ctx.job_l, ctx.pred_l
    s_next = state.next_step
    seg_of_next = seg_global(s_next, wl.sps, wl.phase, ctx.nph_f)
    seg_ok = (seg_of_next == state.seg_idx[:, job]) & \
        (tick >= state.seg_ready[:, job])
    boundary = torch.remainder(s_next, wl.pass_steps) == 0
    w_prev = torch.remainder(s_next - 1, W).long()
    ps_prev = torch.gather(state.step_of[:, pred], 2, w_prev[..., None])[..., 0]
    sent_prev = torch.gather(state.sent[:, pred], 2, w_prev[..., None])[..., 0]
    prev_chunk = ctx.chunk_of(
        job, seg_global(s_next - 1, wl.sps, wl.phase, ctx.nph_f))
    done_pred = state.done_upto[:, pred]
    pred_prev_done = (done_pred >= s_next) | (ps_prev > s_next - 1) | \
        ((ps_prev == s_next - 1) & (sent_prev >= prev_chunk))
    pass_done = (state.done_upto >= s_next) & (done_pred >= s_next)
    ring_ok = torch.where(boundary, (s_next == 0) | pass_done, pred_prev_done)
    ring_ok = ring_ok & (tick >= wl.fstart_ticks)
    w_next = torch.remainder(s_next, W).long()
    slot = torch.gather(state.step_of, 2, w_next[..., None])[..., 0]
    slot_free = (slot < 0) | (slot < state.done_upto)
    can = (s_next < wl.total_steps) & seg_ok & ring_ok & slot_free
    # the one window slot each flow starts into this tick
    sel = (torch.arange(W, device=ctx.device) == w_next[..., None]) & \
        can[..., None]
    lr = ctx.line_rate[..., None]
    return Starts(
        next_step=torch.where(can, s_next + 1, s_next),
        step_of=torch.where(sel, s_next[..., None], state.step_of),
        sent=torch.where(sel, 0.0, state.sent),
        rate=torch.where(sel, lr, state.rate),
        target=torch.where(sel, lr, state.target),
        alpha_cc=torch.where(sel, 1.0, state.alpha_cc),
        stage=torch.where(sel, 0, state.stage),
        lam=torch.where(sel, 0.0, state.lam),
        can=can,
    )


# ------------------------------------------------------- 2. instance view
class InstView(NamedTuple):
    """Flattened ``[B, FW]`` per-instance arrays for this tick."""
    istep: torch.Tensor; isent: torch.Tensor; irate: torch.Tensor
    iseg: torch.Tensor; ichunk: torch.Tensor; iwire: torch.Tensor
    ipsn: torch.Tensor
    occupied: torch.Tensor; retired: torch.Tensor; complete: torch.Tensor
    active: torch.Tensor
    iroute: torch.Tensor      # [B, FW, H] link ids (int64)
    flat_links: torch.Tensor  # [B, FW*H]
    idom: torch.Tensor        # [B, FW, H] Symphony domain per hop
    dj: torch.Tensor          # [B, FW, H] (domain, job) row ids (int64)
    djf: torch.Tensor         # [B, FW*H]

    @property
    def H(self) -> int:
        return int(self.iroute.shape[-1])

    def per_hop(self, x: torch.Tensor) -> torch.Tensor:
        return per_hop(x, self.H)

    def link_sum(self, ctx: "EngineCtx", vals: torch.Tensor) -> torch.Tensor:
        """Ordered scatter-add of per-instance ``vals`` onto the links."""
        zero = torch.zeros(ctx.B, ctx.L + 1, dtype=torch.float32,
                           device=ctx.device)
        return ordered_segment_sum(zero, self.flat_links, self.per_hop(vals))

    def path_min(self, per_link: torch.Tensor) -> torch.Tensor:
        """Worst per-hop value along each instance's path: [B, FW]."""
        return lane_take(per_link, self.iroute).amin(dim=2)


def select_routes(ctx: EngineCtx, istep: torch.Tensor,
                  per_step_ecmp: bool) -> torch.Tensor:
    """Per-instance routes ``[B, FW, H]`` (int64).  With per-step ECMP the
    step index is part of the 5-tuple (paper §4.7), so each step re-rolls
    its hash over the flow's candidate-path table; the hash is the
    reference's uint32 arithmetic, carried in int64 and masked."""
    if not per_step_ecmp:
        return ctx.iroute_static
    choice = ecmp_choice(ctx.ecmp_base, istep, ctx.n_paths_i)
    rows = (ctx.path_row0 + choice)[..., None].expand(ctx.B, -1, ctx.H)
    return torch.gather(ctx.path_flat, 1, rows)


def ecmp_hash_base(flow: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The per-run part of the per-step ECMP hash, ``[B, FW]``: the
    reference's ``flow * 2654435761 + (seed + 1) * 2246822519`` in uint32,
    carried in int64 (``flow`` ``[FW]`` int64, ``seed`` ``[B]``)."""
    seed1 = (seed.long() + 1) & _M32
    return (mul32(flow, 2654435761)[None]
            + mul32(seed1, 2246822519)[:, None]) & _M32


def ecmp_choice(base: torch.Tensor, istep: torch.Tensor,
                n_paths: torch.Tensor) -> torch.Tensor:
    """Per-step ECMP candidate index of every instance, ``[B, FW]``: the
    step joins the hash (``max(step, 0) * 40503``), which is then mixed
    and taken modulo each flow's path count ``n_paths`` (``[B, FW]``)."""
    h = (base + torch.clamp(istep, min=0).long() * 40503) & _M32
    h = mul32(h ^ (h >> 13), 2654435761)
    h = h ^ (h >> 16)
    return h % n_paths


def ecmp_routes(path_table: torch.Tensor, n_paths: torch.Tensor,
                seed: torch.Tensor, flow: torch.Tensor, istep: torch.Tensor
                ) -> torch.Tensor:
    """Per-step ECMP: hash (flow, step, seed) over each flow's candidate
    paths and return the chosen rows of ``path_table`` ``[B, F, P, H]`` as
    ``[B, FW, H]``.  ``flow`` is ``[FW]`` (int64), ``istep`` ``[B, FW]``,
    ``seed`` ``[B]``."""
    choice = ecmp_choice(ecmp_hash_base(flow, seed), istep,
                         n_paths[:, flow].long())
    B, F, P, H = path_table.shape
    rows = (flow[None] * P + choice)[..., None].expand(B, -1, H)
    return torch.gather(path_table.reshape(B, F * P, H), 1, rows)


def instance_view(ctx: EngineCtx, starts: Starts, state: EngineState,
                  mtu: float, per_step_ecmp: bool,
                  iroute: torch.Tensor | None = None) -> InstView:
    """Assemble the per-instance view.  ``iroute`` may be precomputed (the
    fused kernel selects routes on the card and hands them back)."""
    st, J, B, FW = ctx.st, ctx.J, ctx.B, ctx.FW
    istep = starts.step_of.reshape(B, FW)
    isent = starts.sent.reshape(B, FW)
    irate = starts.rate.reshape(B, FW)
    iseg = seg_global(istep, ctx.sps_i, ctx.phase_i, ctx.nph_i)
    ichunk = ctx.chunk_of(ctx.inst_job_l, iseg)
    iwire = wire_step(istep, ctx.sps_i, ctx.phase_i, ctx.nph_i) + ctx.off_i
    occupied = istep >= 0
    retired = occupied & (istep < state.done_upto[:, ctx.inst_flow_l])
    complete = occupied & (isent >= ichunk)
    active = occupied & ~complete & ~retired
    if iroute is None:
        iroute = select_routes(ctx, istep, per_step_ecmp)
    iroute = iroute.long()
    idom = lane_take(st.link_dom, iroute)
    dj = idom.long() * J + ctx.inst_job_l[None, :, None]
    return InstView(
        istep=istep, isent=isent, irate=irate, iseg=iseg, ichunk=ichunk,
        iwire=iwire, ipsn=div_scalar(isent, mtu),
        occupied=occupied, retired=retired, complete=complete, active=active,
        iroute=iroute, flat_links=iroute.reshape(B, -1),
        idom=idom, dj=dj, djf=dj.reshape(B, -1),
    )


# ---------------------------------------------------- 3. bandwidth sharing
def background_load(ctx: EngineCtx, tick: int) -> torch.Tensor:
    st = ctx.st
    period = st.bg_period_ticks
    bg_on = torch.remainder(tick, period).to(torch.float32) < \
        st.bg_duty * period.to(torch.float32)
    return st.bg_base + torch.where(bg_on[:, None], st.bg_amp, 0.0)


class ShareResult(NamedTuple):
    eff: torch.Tensor       # [B, FW] delivered bytes/s per instance
    offered: torch.Tensor   # [B, L+1] offered load per link


def share_proportional(ctx: EngineCtx, cfg, inst: InstView, tick: int
                       ) -> ShareResult:
    """Fluid max-min approximation: every link scales its offered load by
    cap/offered; an instance gets the worst scale along its path."""
    st = ctx.st
    w_rate = torch.where(inst.active, inst.irate, 0.0)
    bg = background_load(ctx, tick)
    offered = inst.link_sum(ctx, w_rate) + bg
    s_l = torch.clamp(st.cap / torch.clamp(offered, min=1.0), max=1.0)
    return ShareResult(eff=w_rate * inst.path_min(s_l), offered=offered)


def job_min_wire(ctx: EngineCtx, inst: InstView) -> torch.Tensor:
    """Oldest active wire step of each job, ``[B, J]`` (BIG if none)."""
    return segment_min(BIG, ctx.J, ctx.inst_job_l[None],
                       torch.where(inst.active, inst.iwire, BIG))


def share_pq(ctx: EngineCtx, cfg, inst: InstView, tick: int) -> ShareResult:
    """2-class strict priority: the job's oldest active step is high class
    (Fig. 5 "PQ"); the low class shares what remains."""
    st = ctx.st
    w_rate = torch.where(inst.active, inst.irate, 0.0)
    bg = background_load(ctx, tick)
    jmin = job_min_wire(ctx, inst)
    is_hi = inst.active & (inst.iwire <= jmin[:, ctx.inst_job_l])
    hi_rate = torch.where(is_hi, inst.irate, 0.0)
    off_hi = inst.link_sum(ctx, hi_rate) + bg
    s_hi = torch.clamp(st.cap / torch.clamp(off_hi, min=1.0), max=1.0)
    rem = torch.clamp(st.cap - off_hi * s_hi, min=0.0)
    lo_rate = torch.where(inst.active & ~is_hi, inst.irate, 0.0)
    off_lo = inst.link_sum(ctx, lo_rate)
    s_lo = rem / torch.clamp(off_lo, min=1.0)
    share = torch.where(is_hi[..., None], lane_take(s_hi, inst.iroute),
                        torch.clamp(lane_take(s_lo, inst.iroute), max=1.0))
    return ShareResult(eff=w_rate * share.amin(dim=2), offered=off_hi + off_lo)


def share_wfq(ctx: EngineCtx, cfg, inst: InstView, tick: int) -> ShareResult:
    """Weighted fair sharing over job weights (``Static.job_weight``),
    capped at each instance's own rate (one-shot water-filling)."""
    st = ctx.st
    w_rate = torch.where(inst.active, inst.irate, 0.0)
    bg = background_load(ctx, tick)
    wgt = st.job_weight[:, ctx.inst_job_l]
    w_act = torch.where(inst.active, wgt, 0.0)
    wsum = inst.link_sum(ctx, w_act)
    avail = torch.clamp(st.cap - bg, min=0.0)
    fair = avail / torch.clamp(wsum, min=1e-9)
    allowed = wgt[..., None] * lane_take(fair, inst.iroute)
    eff = torch.minimum(w_rate, allowed.amin(dim=2))
    return ShareResult(eff=eff, offered=inst.link_sum(ctx, w_rate) + bg)


def share_drr(ctx: EngineCtx, cfg, inst: InstView, tick: int) -> ShareResult:
    """Deficit round-robin (fluid approximation, two-round water-filling)."""
    st = ctx.st
    w_rate = torch.where(inst.active, inst.irate, 0.0)
    bg = background_load(ctx, tick)
    n_act = inst.link_sum(ctx, inst.active.to(torch.float32))
    avail = torch.clamp(st.cap - bg, min=0.0)
    quantum = avail / torch.clamp(n_act, min=1.0)
    take1 = torch.minimum(w_rate, inst.path_min(quantum))
    used = inst.link_sum(ctx, take1)
    want = inst.active & (take1 < w_rate)
    n_want = inst.link_sum(ctx, want.to(torch.float32))
    bonus = torch.clamp(avail - used, min=0.0) / torch.clamp(n_want, min=1.0)
    take2 = torch.where(
        want, torch.minimum(w_rate - take1, inst.path_min(bonus)), 0.0)
    return ShareResult(eff=take1 + take2,
                       offered=inst.link_sum(ctx, w_rate) + bg)


SHARE_POLICIES: dict[str, Callable[..., ShareResult]] = {
    "proportional": share_proportional,
    "pq": share_pq,
    "wfq": share_wfq,
    "drr": share_drr,
}


def resolve_share_policy(cfg) -> Callable[..., ShareResult]:
    """The base policy of ``cfg``; raises on unknown names and on a
    ``pq_on`` lane over a wfq/drr structure."""
    name = cfg.share_policy
    if name not in SHARE_POLICIES:
        raise ValueError(
            f"unknown share policy {name!r}; have {sorted(SHARE_POLICIES)}")
    if getattr(cfg, "pq_lanes", "none") != "none" and \
            name not in ("proportional", "pq"):
        raise ValueError(
            f"pq_on=True conflicts with share_policy={name!r}; "
            "use pq only over a proportional-base structure")
    return SHARE_POLICIES[name]


def stage_share(ctx: EngineCtx, cfg, inst: InstView, tick: int
                ) -> ShareResult:
    """Bandwidth sharing with the per-lane ``pq_on`` override (the
    reference's ``lax.cond`` under vmap: both policies, then a select)."""
    base_fn = resolve_share_policy(cfg)
    if base_fn is share_pq or cfg.pq_lanes == "all":
        return share_pq(ctx, cfg, inst, tick)
    if cfg.pq_lanes == "none":
        return base_fn(ctx, cfg, inst, tick)
    gate = cfg.pq_on != 0
    a = share_pq(ctx, cfg, inst, tick)
    b = base_fn(ctx, cfg, inst, tick)
    return ShareResult(eff=torch.where(gate[:, None], a.eff, b.eff),
                       offered=torch.where(gate[:, None], a.offered,
                                           b.offered))


# --------------------------------------------------------- 4. queues + RED
def stage_queues(ctx: EngineCtx, cfg, q_prev, offered):
    """Integrate per-link queues and derive the RED marking profile."""
    q = torch.clamp(q_prev + (offered - ctx.st.cap) * cfg.dt, min=0.0)
    q[:, ctx.L] = 0.0
    kmin, kmax = _knob(cfg.red_kmin, 1), _knob(cfg.red_kmax, 1)
    p_red = torch.clamp((q - kmin) / (kmax - kmin), 0.0, 1.0) * \
        _knob(cfg.red_pmax, 1)
    return q, p_red


# ------------------------------------------------------------- 5. marking
def stage_marking(ctx: EngineCtx, cfg, state: EngineState, inst: InstView,
                  p_red, eff, lam, tick: int):
    """Combine RED with Symphony's selective marking along each path into
    the per-instance expected-mark accumulator lambda."""
    sm = lane_take(state.s_stepmin, inst.dj)
    no_mark = 1.0 - lane_take(p_red, inst.iroute)
    if tick >= cfg.sym_from:
        pw = lane_take(state.s_psnwin, inst.dj)
        al = lane_take(state.s_alpha, inst.dj)
        sym = SymphonyParams(*(_knob(x, 2) for x in cfg.sym))
        p_sym = marking_probability(inst.iwire[..., None],
                                    inst.ipsn[..., None], sm, pw, al, sym)
        p_sym = torch.where(inst.idom < ctx.D, p_sym, 0.0)
        sym_gate = (cfg.sym_on != 0) & (tick >= cfg.sym_start_tick)
        p_sym = torch.where(_knob(sym_gate, 2), p_sym, 0.0)
        no_mark = no_mark * (1.0 - p_sym)
    # else no lane marks with Symphony yet: p_sym is 0, and (1 - 0) = 1
    # leaves the product unchanged
    p_hop = 1.0 - no_mark
    terms = log1p_neg(torch.clamp(p_hop, max=0.999999))
    log_nomark = terms[..., 0]
    for h in range(1, terms.shape[-1]):
        log_nomark = log_nomark + terms[..., h]
    p_inst = 1.0 - torch.exp(log_nomark)
    pkts = div_scalar(eff * cfg.dt, cfg.mtu)
    lam = (lam.reshape(ctx.B, ctx.FW) +
           torch.where(inst.active, p_inst * pkts, 0.0)
           ).reshape(ctx.B, ctx.F, ctx.W)
    return lam, pkts, sm


# ------------------------------------------------------------ 6. progress
def stage_progress(ctx: EngineCtx, cfg, state: EngineState, inst: InstView,
                   step_of, eff, tick: int):
    """Advance per-instance bytes, retire completed steps in order, record
    per-slot finish ticks."""
    wl = ctx.wl
    isent_new = inst.isent + eff * cfg.dt
    newly_done = inst.active & (isent_new >= inst.ichunk)
    sent = isent_new.reshape(ctx.B, ctx.F, ctx.W)
    done_upto = state.done_upto
    for _ in range(2):  # <=2 completions per slot per tick in practice
        wsel = torch.remainder(done_upto, ctx.W).long()[..., None]
        ch = ctx.chunk_of(
            ctx.job_l, seg_global(done_upto, wl.sps, wl.phase, ctx.nph_f))
        ok = (torch.gather(step_of, 2, wsel)[..., 0] == done_upto) & \
            (torch.gather(sent, 2, wsel)[..., 0] >= ch)
        done_upto = done_upto + ok.to(torch.int32)
    finish = torch.where((done_upto >= wl.total_steps) &
                         (state.finish == I32MAX), tick, state.finish)
    return sent, done_upto, finish, newly_done


# ------------------------------------------------------ 7. Symphony state
def stage_symphony(ctx: EngineCtx, cfg, state: EngineState, inst: InstView,
                   sm, pkts, newly_done, eff, tick: int):
    """Per-(domain, job) state blocks: traffic stats, optimistic step-min
    advancement with lazy correction, windowed alpha update (Alg. 1)."""
    cnt, cntop, stepmin, psnwin = symphony_rows(
        state.s_stepmin, state.s_psnwin, state.s_cnt, state.s_cntop,
        inst.djf, sm, inst.active, newly_done, inst.active & (eff > 1.0),
        inst.iwire, inst.ipsn, pkts)

    sym_epoch = torch.remainder(tick, cfg.sym_win_ticks) == \
        (cfg.sym_win_ticks - 1)
    return (stepmin,) + symphony_epoch(
        state.s_alpha, cnt, cntop, psnwin, sym_epoch, cfg.sym.n_sample,
        cfg.sym.tau, cfg.sym.alpha_max)


def symphony_epoch(s_alpha, cnt, cntop, psnwin, sym_epoch, n_sample, tau,
                   alpha_max):
    """The end-of-window update (Eq. 2/3 via Eq. 5) on lanes whose window
    closes this tick (``sym_epoch`` and the knobs are ``[B]``): alpha moves
    by +-1 behind the Sample Guard, and the counters and psn window reset.
    Returns ``(s_psnwin, s_alpha, s_cnt, s_cntop)``."""
    ep = _knob(sym_epoch, 1)
    have = cnt > _knob(n_sample, 1)
    exceed = cntop >= _knob(tau, 1) * cnt
    step = torch.where(exceed, 1.0, -1.0) * have.to(torch.float32)
    alpha_new = torch.minimum(torch.clamp(s_alpha + step, min=1.0),
                              _knob(alpha_max, 1))
    return (torch.where(ep, 0.0, psnwin), torch.where(ep, alpha_new, s_alpha),
            torch.where(ep, 0.0, cnt), torch.where(ep, 0.0, cntop))


def symphony_rows(s_stepmin, s_psnwin, s_cnt, s_cntop, djf, sm, active,
                  done, send, iwire, ipsn, pkts):
    """The per-(domain, job) scatter of one tick: traffic counters (ordered
    float sums), optimistic step-min advancement with lazy correction, and
    the psn window.  Per-instance ``[B, FW]`` values are broadcast over the
    ``H`` hops of ``sm`` ``[B, FW, H]`` (the pre-update step-min of each
    hop's row) and aligned with ``djf`` ``[B, FW*H]``.  Returns ``(cnt,
    cntop, stepmin, psnwin)`` before the window epoch."""
    B, FW, H = sm.shape
    DJ = s_stepmin.shape[1]

    def hops(x):
        return x.expand(B, FW, H).reshape(B, FW * H)

    pk_act = torch.where(active, pkts, 0.0)[..., None]
    cnt = ordered_segment_sum(s_cnt, djf, hops(pk_act))
    cntop = ordered_segment_sum(
        s_cntop, djf, torch.where(iwire[..., None] > sm, pk_act, 0.0
                                  ).reshape(B, FW * H))
    cand = segment_max_into(torch.zeros_like(s_stepmin), djf,
                            hops(torch.where(done, iwire + 1, 0)[..., None]))
    cand = torch.maximum(s_stepmin, cand)
    min_act = segment_min(BIG, DJ, djf, hops(
        torch.where(active & ~done, iwire, BIG)[..., None]))
    stepmin = torch.where(min_act < BIG, torch.minimum(cand, min_act), cand)
    at_min = iwire[..., None] == lane_take(stepmin, djf).reshape(B, FW, H)
    psnwin = segment_max_into(
        s_psnwin, djf,
        torch.where(at_min & (send & ~done)[..., None],
                    (ipsn + pkts)[..., None], 0.0).reshape(B, FW * H))
    return cnt, cntop, stepmin, psnwin


# -------------------------------------------------------- 8. rate control
def stage_rate_control(ctx: EngineCtx, cfg, starts: Starts, lam, key,
                       tick: int):
    """DCQCN-style epoch update driven by the accumulated mark probability.

    Lanes whose epoch fires draw their coin flips (the key advances only
    there); the others keep their state.  When no lane fires (known on the
    host from ``cfg.cc_periods``) the draw is skipped altogether."""
    keep = (starts.rate, starts.target, starts.alpha_cc, starts.stage, lam,
            key)
    if not any(tick % p == p - 1 for p in cfg.cc_periods):
        return keep
    F, W = ctx.F, ctx.W
    rate, target, alpha_cc, stage = keep[:4]
    key_n, sub = prng.split(key)
    u = prng.uniform(sub, (F, W))
    cut = (u < 1.0 - torch.exp(-lam)) & (starts.step_of >= 0)
    g = _knob(cfg.cc_g, 2)
    fr = _knob(cfg.cc_fr_stages, 2)
    r_c = torch.maximum(rate * (1.0 - alpha_cc / 2.0),
                        _knob(cfg.cc_min_rate, 2))
    t_c = torch.where(stage > 0, rate, target)
    a_c = (1.0 - g) * alpha_cc + g
    a_n = (1.0 - g) * alpha_cc
    stage_n = stage + 1
    zero = torch.zeros((), dtype=torch.float32, device=ctx.device)
    tgt_inc = torch.where(stage_n > fr,
                          torch.where(stage_n > 2 * fr, _knob(cfg.cc_rhai, 2),
                                      _knob(cfg.cc_rai, 2)), zero)
    lr = ctx.line_rate[..., None]
    t_n = torch.minimum(target + tgt_inc, lr)
    r_n = torch.minimum((rate + t_n) / 2.0, lr)
    new = (torch.where(cut, r_c, r_n), torch.where(cut, t_c, t_n),
           torch.where(cut, a_c, a_n), torch.where(cut, 0, stage_n),
           torch.zeros_like(lam))
    epoch = torch.remainder(tick, cfg.cc_epoch_ticks) == \
        (cfg.cc_epoch_ticks - 1)
    e3 = _knob(epoch, 2)
    out = tuple(torch.where(e3, n, o) for n, o in zip(new, keep[:5]))
    return out + (torch.where(epoch[:, None], key_n, key),)


# ----------------------------------------------------- 9. segments / jobs
def stage_segments(ctx: EngineCtx, state: EngineState, done_upto, tick: int):
    """Advance the job-wide segment barrier and record job finish ticks."""
    wl, J, job = ctx.wl, ctx.J, ctx.job_l
    seg_phase = torch.remainder(state.seg_idx, wl.n_phases)
    participating = wl.phase == seg_phase[:, job]
    c_end = (torch.div(state.seg_idx[:, job], ctx.nph_f,
                       rounding_mode="floor") + 1) * wl.sps
    flow_done = ((~participating) | (done_upto >= c_end)).to(torch.int32)
    seg_done = segment_min(1, J, job[None], flow_done) > 0
    adv = seg_done & (state.seg_idx < wl.n_segs) & (tick >= state.seg_ready)
    seg_idx = state.seg_idx + adv.to(torch.int32)
    new_phase0 = torch.remainder(seg_idx, wl.n_phases) == 0
    seg_ready = torch.where(adv, tick + torch.where(new_phase0, wl.gap_ticks, 0),
                            state.seg_ready)
    job_finish = torch.where((seg_idx >= wl.n_segs) &
                             (state.job_finish == I32MAX),
                             tick, state.job_finish)
    # Dependency-triggered arrivals: a pending job (seg_ready still at the
    # I32MAX sentinel) is released once its trigger job's segment barrier
    # has advanced past the required count.
    trig_src = torch.clamp(wl.trig_job, 0, J - 1).long()
    fired = (wl.trig_job >= 0) & (state.seg_ready == I32MAX) & \
        (seg_idx[:, trig_src] >= wl.trig_seg)
    seg_ready = torch.where(fired, tick + wl.trig_delay_ticks + wl.gap_ticks,
                            seg_ready)
    return seg_idx, seg_ready.to(torch.int32), job_finish


# ------------------------------------------------------------ 10. metrics
def stage_metrics(ctx: EngineCtx, inst: InstView, done_upto, eff, q, s_alpha):
    """The sampled observables of one tick, each with a leading lane axis."""
    J, L = ctx.J, ctx.L
    jidx = ctx.inst_job_l[None]
    min_wire = segment_min(BIG, J, jidx,
                           torch.where(inst.active, inst.iwire, BIG))
    max_wire = segment_max_into(
        torch.full_like(min_wire, -1), jidx,
        torch.where(inst.active, inst.iwire, -1))
    done_min = segment_min(BIG, J, ctx.job_l[None], done_upto)
    # masked sum over a fixed axis, as the reference does
    mask = ctx.inst_job_l[None, :] == torch.arange(J, device=ctx.device)[:, None]
    tput = torch.where(mask[None], eff[:, None, :], 0.0).sum(dim=2)
    return (min_wire, max_wire, done_min, tput, q[:, :L].amax(dim=1),
            s_alpha.amax(dim=1))


# ------------------------------------------------------------ composition
BACKENDS = ("eager", "cuda")
_FALLBACK_WARNED: set = set()


def resolve_backend(cfg) -> str:
    """The tick backend actually used for this config.

    ``backend="cuda"`` runs the hot stages in the ``kernels/netsim_tick``
    CUDA kernel, which implements the ``proportional`` and ``pq`` share
    paths (plus the per-lane ``pq_on`` gate); ``wfq``/``drr`` fall back to
    the eager tick, with one ``warnings.warn`` per policy.
    """
    be = getattr(cfg, "backend", "eager")
    if be not in BACKENDS:
        raise ValueError(f"unknown tick backend {be!r}; have {BACKENDS}")
    if be == "cuda" and cfg.share_policy not in ("proportional", "pq"):
        if cfg.share_policy not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(cfg.share_policy)
            warnings.warn(
                f"backend='cuda' with share_policy={cfg.share_policy!r} "
                "falls back to the eager tick: the fused kernel only "
                "implements the proportional/pq share paths",
                stacklevel=2)
        return "eager"
    return be


def engine_tick(ctx: EngineCtx, cfg, state: EngineState, tick: int,
                sample: bool = True):
    """One tick: compose the stages.  Returns ``(state', sample)``; the
    metric sample is ``None`` when ``sample`` is False (the drivers only
    keep the last tick of each record period)."""
    if resolve_backend(cfg) == "cuda":
        from ...kernels.netsim_tick.ops import engine_tick_fused
        return engine_tick_fused(ctx, cfg, state, tick, sample)
    return engine_tick_eager(ctx, cfg, state, tick, sample)


def engine_tick_eager(ctx: EngineCtx, cfg, state: EngineState, tick: int,
                      sample: bool = True):
    """The staged torch tick (the reference semantics of the engine)."""
    starts = stage_starts(ctx, state, tick)
    inst = instance_view(ctx, starts, state, cfg.mtu, cfg.per_step_ecmp)
    shr = stage_share(ctx, cfg, inst, tick)
    q, p_red = stage_queues(ctx, cfg, state.q, shr.offered)
    lam, pkts, sm = stage_marking(ctx, cfg, state, inst, p_red, shr.eff,
                                  starts.lam, tick)
    sent, done_upto, finish, newly_done = stage_progress(
        ctx, cfg, state, inst, starts.step_of, shr.eff, tick)
    stepmin, s_psnwin, s_alpha, s_cnt, s_cntop = stage_symphony(
        ctx, cfg, state, inst, sm, pkts, newly_done, shr.eff, tick)
    rate, target, alpha_cc, stage, lam, key = stage_rate_control(
        ctx, cfg, starts, lam, state.key, tick)
    seg_idx, seg_ready, job_finish = stage_segments(ctx, state, done_upto,
                                                    tick)
    smp = (stage_metrics(ctx, inst, done_upto, shr.eff, q, s_alpha)
           if sample else None)
    new_state = EngineState(
        next_step=starts.next_step, done_upto=done_upto, finish=finish,
        step_of=starts.step_of, sent=sent, rate=rate, target=target,
        alpha_cc=alpha_cc, stage=stage, lam=lam, q=q,
        s_stepmin=stepmin, s_psnwin=s_psnwin, s_alpha=s_alpha,
        s_cnt=s_cnt, s_cntop=s_cntop,
        seg_idx=seg_idx, seg_ready=seg_ready, job_finish=job_finish,
        key=key,
    )
    return new_state, smp
