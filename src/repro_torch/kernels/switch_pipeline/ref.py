"""Plain torch versions of the Alg. 1 switch pipeline (the kernel's oracles).

:func:`pipeline_plain` computes what ``csrc/switch_pipeline.cu`` computes,
the counterpart of the reference's ``_pipeline_kernel``
(``src/repro/kernels/switch_pipeline/kernel.py:42``): one walk over a
packet batch carrying the Per-Job State Block (step_min, psn_rec, alpha,
Cnt_total, Cnt_op), with the kernel's float order for the marking
probability, ``((k * alpha) * psn) / max(psn_rec, 1)``, and the
``exact=False`` log2-domain compare through the 16-entry mantissa LUT.

The state block only ever takes exact values (integer steps and counts,
copies of the packets' psn, alpha moved by +-1 and clipped), so its walk
runs on the host in float32 scalars; the marking decisions, where float
rounding matters, are torch ops on the inputs' device.

:func:`pipeline_ref` is the oracle over the port's ``core/symphony.py``:
``process_packet`` then ``window_update`` per packet, with symphony.py's
own float order ``k * (alpha * (psn / max(psn_rec, 1)))``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.symphony import (Packet, SymphonyParams, init_state,
                              process_packet, window_update)

__all__ = ["LOG2_LUT", "lut_log2", "pipeline_plain", "pipeline_ref"]

# 16-entry mantissa log2 LUT: log2(1 + i/16), the kind of table a switch ALU
# indexes with the mantissa's top 4 bits (the reference's table).
LOG2_LUT = np.log2(1.0 + np.arange(16) / 16.0).astype(np.float32)


def lut_log2(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant log2: ``e = floor(log2(x))`` (an ASIC's CLZ), the
    mantissa ``x / 2**e`` in [1, 2), and its top 4 bits index ``lut``."""
    e = torch.floor(torch.log2(torch.clamp(x, min=1e-30)))
    m = x / torch.exp2(e)
    idx = torch.clamp(((m - 1.0) * 16.0).to(torch.int32), 0, 15)
    return e + lut[idx.long()]


def _state_walk(steps, psns, lasts, win_ends, tau, n_sample, alpha_max):
    """The state block before and after each packet, in float32 scalars:
    ``(pre, post)`` with ``pre = (step_min, psn_rec, alpha)`` and ``post =
    (step_min, psn_rec, alpha)`` numpy float32 arrays of length P."""
    f32 = np.float32
    tau, n_sample, alpha_max = f32(tau), f32(n_sample), f32(alpha_max)
    one, zero = f32(1.0), f32(0.0)
    P = len(steps)
    pre = np.empty((3, P), np.float32)
    post = np.empty((3, P), np.float32)
    step_min, psn_rec, alpha, cnt, cnt_op = zero, zero, one, zero, zero
    for i in range(P):
        step, psn = f32(steps[i]), psns[i]
        pre[:, i] = step_min, psn_rec, alpha
        # UpdateTrafficStats against the state before this packet
        cnt = cnt + one
        if step > step_min:
            cnt_op = cnt_op + one
        # progress tracking (Alg. 1 l.3-10)
        if lasts[i] > 0:
            step_min, psn_rec = step + one, zero
        elif step < step_min:
            step_min, psn_rec = step, psn
        elif step == step_min:
            psn_rec = max(psn_rec, psn)
        # T_win boundary: Eq. 5 integer test + windowed psn reset
        if win_ends[i] > 0:
            if cnt > n_sample:
                alpha = alpha + (one if cnt_op >= tau * cnt else -one)
            alpha = min(max(alpha, one), alpha_max)
            cnt, cnt_op, psn_rec = zero, zero, zero
        post[:, i] = step_min, psn_rec, alpha
    return pre, post


def pipeline_plain(steps, psns, lasts, win_ends, uniforms, *, k=0.01,
                   tau=0.25, n_warmup=16, n_sample=32, alpha_max=64.0,
                   exact=True):
    """Alg. 1 over a packet batch, the kernel's plain version.  All inputs
    ``[P]`` (steps, lasts, win_ends i32; psns, uniforms f32) on one device.
    Returns ``(marks i32, step_min i32, psn_rec f32, alpha f32)`` per
    packet: the mark decision and the state after the packet."""
    dev = steps.device
    pre, post = _state_walk(
        steps.cpu().numpy(), psns.cpu().numpy(), lasts.cpu().numpy(),
        win_ends.cpu().numpy(), tau, n_sample, alpha_max)
    pre = torch.from_numpy(pre).to(dev)
    post = torch.from_numpy(post).to(dev)
    smin_pre, prec_pre, alpha_pre = pre.unbind(0)
    psn = psns.to(torch.float32)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    outpacing = (steps.to(torch.float32) > smin_pre) & \
        (prec_pre > f32(n_warmup))
    one = f32(1.0)
    if exact:
        p = torch.minimum(
            one, f32(k) * alpha_pre * psn / torch.maximum(prec_pre, one))
        mark = outpacing & (uniforms < p)
    else:
        lut = torch.from_numpy(LOG2_LUT).to(dev)
        lp = (lut_log2(f32(k), lut) + lut_log2(alpha_pre, lut)
              + lut_log2(torch.maximum(psn, one), lut)
              - lut_log2(torch.maximum(prec_pre, one), lut))
        mark = outpacing & (
            lut_log2(torch.maximum(uniforms, f32(1e-9)), lut) < lp)
    smin, prec, alpha = post.unbind(0)
    return (mark.to(torch.int32), smin.to(torch.int32), prec.contiguous(),
            alpha.contiguous())


def pipeline_ref(steps, psns, lasts, win_ends, uniforms,
                 params: SymphonyParams = SymphonyParams()):
    """Sequential Alg. 1 through ``core/symphony.py``: ``process_packet``,
    then ``window_update`` on a window-end packet.  Returns ``(marks,
    step_min, psn_rec, alpha)`` trajectories, the post-packet state."""
    st = init_state(device=steps.device)
    out = []
    for i in range(int(steps.shape[0])):
        st, mark = process_packet(
            st, Packet(steps[i], psns[i], lasts[i] > 0), params, uniforms[i])
        if int(win_ends[i]) > 0:
            st = window_update(st, params)
        out.append((mark, st.step_min, st.psn_rec, st.alpha))
    marks, smin, prec, alpha = (torch.stack(x) for x in zip(*out))
    return marks.to(torch.int32), smin, prec, alpha
