"""Symphony's per-job switch state machine (paper Alg. 1, Eq. 1-5) in torch.

Counterpart of ``repro.core.symphony``: the Per-Job State Block kept by a
switch egress port, the selective-throttling marking decision and the
windowed adaptive-aggressiveness update.  Every function works on tensors
of any (broadcastable) shape, so the fluid simulator reuses
:func:`marking_probability` on its ``[B, FW, H]`` per-hop views.

Terminology follows the paper:
  step      logical ring-collective stage s_0 .. s_n of a job
  psn       packet sequence number within the flow (fluid model: bytes/MTU)
  LAST bit  RDMA WRITE "LAST" flag == step-completion signal
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = [
    "SymphonyParams",
    "SymphonyState",
    "Packet",
    "init_state",
    "process_packet",
    "window_update",
    "marking_probability",
    "process_packet_batch",
]


class SymphonyParams(NamedTuple):
    """Control parameters (paper Table 1 + §3.3/§3.4 defaults).  Fields are
    Python numbers or float32 tensors (one entry per simulation lane)."""

    k: torch.Tensor | float = 0.01          # throttling gain (Eq. 4)
    tau: torch.Tensor | float = 0.25        # outpacing tolerance (Eq. 3)
    n_warmup: torch.Tensor | int = 16       # psn_rec warm-up guard (Alg. 1 l.11)
    n_sample: torch.Tensor | int = 32       # Sample Guard for the window update
    alpha_max: torch.Tensor | float = 64.0  # numerical cap on alpha(t)


class SymphonyState(NamedTuple):
    """Per-(egress port, job) state block; fields share one shape."""

    step_min: torch.Tensor   # i32 — global synchronization anchor
    psn_rec: torch.Tensor    # f32 — time-windowed max PSN within step_min
    alpha: torch.Tensor      # f32 — adaptive aggressiveness factor, >= 1
    cnt_total: torch.Tensor  # f32 — packets seen in current window
    cnt_op: torch.Tensor     # f32 — outpacing packets in current window


def init_state(shape=(), device=None) -> SymphonyState:
    """A fresh state block; ``device=None`` is the CUDA card (raises
    without one)."""
    device = resolve_device(device)
    return SymphonyState(
        step_min=torch.zeros(shape, dtype=torch.int32, device=device),
        psn_rec=torch.zeros(shape, dtype=torch.float32, device=device),
        alpha=torch.ones(shape, dtype=torch.float32, device=device),
        cnt_total=torch.zeros(shape, dtype=torch.float32, device=device),
        cnt_op=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def marking_probability(step, psn, step_min, psn_rec, alpha,
                        params: SymphonyParams) -> torch.Tensor:
    """Eq. 1 + Eq. 4 with the Alg. 1 guards; returns P(mark) in [0, 1].

    Lagging/aligned packets (step <= step_min) and warm-up windows
    (psn_rec <= N_warmup) are never marked by Symphony.  Knob tensors in
    ``params`` must already broadcast against the state (the simulator
    hands them in as ``[B, 1, 1]``).
    """
    outpacing = step > step_min
    warm = psn_rec > _f32(params.n_warmup, psn_rec)
    delta = alpha * (psn.to(psn_rec.dtype) / torch.clamp(psn_rec, min=1.0))
    p = torch.clamp(_f32(params.k, psn_rec) * delta, max=1.0)
    return torch.where(outpacing & warm, p, torch.zeros_like(p))


class Packet(NamedTuple):
    step: torch.Tensor      # i32
    psn: torch.Tensor       # f32
    is_last: torch.Tensor   # bool — RDMA WRITE LAST bit


def process_packet(state: SymphonyState, pkt: Packet, params: SymphonyParams,
                   uniform) -> tuple[SymphonyState, torch.Tensor]:
    """One dequeued packet through Alg. 1.  Returns ``(state', to_mark)``.

    ``uniform`` is a U[0,1) sample implementing TossCoin."""
    dev = state.psn_rec.device
    step = torch.as_tensor(pkt.step, dtype=torch.int32, device=dev)
    psn = torch.as_tensor(pkt.psn, dtype=state.psn_rec.dtype, device=dev)

    # l.2 UpdateTrafficStats — uses the state *before* this packet's update.
    is_op = step > state.step_min
    cnt_total = state.cnt_total + 1.0
    cnt_op = state.cnt_op + is_op.to(state.cnt_op.dtype)

    # l.3-10 progress tracking: optimistic advancement + lazy correction.
    is_last = torch.as_tensor(pkt.is_last, dtype=torch.bool, device=dev)
    lt = step < state.step_min
    eq = step == state.step_min
    step_min = torch.where(is_last, step + 1,
                           torch.where(lt, step, state.step_min))
    zero = torch.zeros_like(state.psn_rec)
    psn_rec = torch.where(
        is_last, zero,
        torch.where(lt, psn,
                    torch.where(eq, torch.maximum(state.psn_rec, psn),
                                state.psn_rec)))

    # l.11-17 marking decision against the *pre-update* anchors.
    p = marking_probability(step, psn, state.step_min, state.psn_rec,
                            state.alpha, params)
    to_mark = torch.as_tensor(uniform, dtype=p.dtype, device=dev) < p
    new = SymphonyState(step_min=step_min, psn_rec=psn_rec,
                        alpha=state.alpha, cnt_total=cnt_total, cnt_op=cnt_op)
    return new, to_mark


def window_update(state: SymphonyState, params: SymphonyParams
                  ) -> SymphonyState:
    """End-of-T_win update: Eq. 2/3 via the integer test of Eq. 5."""
    have_samples = state.cnt_total > _f32(params.n_sample, state.cnt_total)
    exceed = state.cnt_op >= _f32(params.tau, state.cnt_op) * state.cnt_total
    one = torch.ones_like(state.alpha)
    delta = torch.where(exceed, one, -one)
    alpha = torch.where(have_samples, state.alpha + delta, state.alpha)
    alpha = torch.minimum(torch.clamp(alpha, min=1.0),
                          _f32(params.alpha_max, alpha))
    zero = torch.zeros_like(state.cnt_total)
    return SymphonyState(step_min=state.step_min, psn_rec=zero, alpha=alpha,
                         cnt_total=zero, cnt_op=zero)


def process_packet_batch(state: SymphonyState, steps, psns, is_lasts,
                         uniforms, params: SymphonyParams
                         ) -> tuple[SymphonyState, torch.Tensor]:
    """Process a batch of packets one after another (the switch ASIC's
    order): ``marks[i]`` is the decision for packet i given packets < i."""
    marks = []
    for i in range(int(steps.shape[0])):
        state, m = process_packet(
            state, Packet(steps[i], psns[i], is_lasts[i]), params, uniforms[i])
        marks.append(m)
    return state, torch.stack(marks)
