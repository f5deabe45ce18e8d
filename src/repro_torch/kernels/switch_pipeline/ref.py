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

__all__ = ["LOG2_LUT", "lut_log2", "pipeline_plain", "pipeline_ref",
           "outputs_from_states", "scan_traces"]

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
    return outputs_from_states(steps, psns, uniforms,
                               torch.from_numpy(pre).to(dev),
                               torch.from_numpy(post).to(dev), k=k,
                               n_warmup=n_warmup, exact=exact)


def outputs_from_states(steps, psns, uniforms, pre, post, *, k=0.01,
                        n_warmup=16, exact=True):
    """The pipeline's outputs from the state block before and after each
    packet (``pre``, ``post``: ``[3, P]`` float32 rows step_min, psn_rec,
    alpha): the marks, decided elementwise against ``pre``, and ``post``."""
    dev = steps.device
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


def scan_traces(tile: int) -> dict:
    """Packet traces that put the cases of the kernel's scan on the edges
    of its ``tile``-packet tiles: ``{name: (arrays, kw)}``, ``arrays`` the
    five numpy inputs (steps, psns, lasts, win_ends, uniforms) and ``kw``
    the pipeline's options where they differ from the defaults.

    * ``edges``: LAST bits and window ends on the last and first packet of
      tiles; P = 4 tiles + 37 (not a multiple of the tile).
    * ``spans``: one window over three tiles, two of them with no window
      end and no LAST bit; a run of packets at the step_min (psn_rec a
      running max) over the same tiles.
    * ``clamps``: 40-packet windows that drive alpha up to a non-integer
      alpha_max (5.5) and back down to 1, across tile edges.
    * ``p1_plain``, ``p1_last``, ``p1_win``: one packet.
    * ``random``: the traces of tests/test_kernels.py, over 3 tiles + 5."""
    rng = np.random.default_rng(tile)
    i32, f32 = np.int32, np.float32

    def pack(steps, psns, lasts, wins, us=None):
        n = len(steps)
        us = rng.random(n) if us is None else us
        return (np.asarray(steps, i32), np.asarray(psns, f32),
                np.asarray(lasts, i32), np.asarray(wins, i32),
                np.asarray(us, f32))

    out = {}
    n = 4 * tile + 37
    steps = np.arange(n) // 50 + rng.integers(0, 4, n)
    lasts = rng.random(n) < 0.02
    wins = np.arange(n) % 97 == 96
    lasts[[tile - 1, tile, 2 * tile - 1, 3 * tile, n - 1]] = True
    wins[[tile - 1, 2 * tile, 3 * tile - 1, 4 * tile, n - 1]] = True
    out["edges"] = (pack(steps, rng.integers(1, 5000, n), lasts, wins), {})

    n = 5 * tile + 11
    q = tile // 4
    steps = np.full(n, 4)
    # a LAST at step 4 sets step_min to 5: then step 5 is at the step_min
    # (psn_rec a running max) and 6 outpaces it
    lasts = np.zeros(n, bool)
    lasts[q - 1] = True
    steps[q:] = np.where(rng.random(n - q) < 0.65, 5, 6)
    tail = 7 * tile // 2
    steps[tail:] = 7 + np.arange(n - tail) // 40
    lasts[tail:] = rng.random(n - tail) < 0.03
    wins = np.zeros(n, bool)
    wins[[tile // 2, 15 * tile // 4, n - tile // 10]] = True
    out["spans"] = (pack(steps, rng.integers(1, 5000, n), lasts, wins), {})

    half = 30 * 40
    n = max(3 * tile + 3, 2 * half + 7)
    # rising steps outpace the step_min (cnt_op = cnt: alpha up), then
    # steps at or below it (cnt_op = 0: alpha down)
    steps = np.where(np.arange(n) < half, 1 + np.arange(n), 0)
    lasts = np.zeros(n, bool)
    wins = np.arange(n) % 40 == 39
    out["clamps"] = (pack(steps, rng.integers(100, 5000, n), lasts, wins),
                     dict(alpha_max=5.5))

    for name, last, win in (("p1_plain", 0, 0), ("p1_last", 1, 0),
                            ("p1_win", 0, 1)):
        out[name] = (pack([3], [77.0], [last], [win]), {})

    n = 3 * tile + 5
    steps = np.maximum(0, rng.integers(0, 6, n) + np.arange(n) // 300)
    out["random"] = (pack(steps, rng.integers(1, 5000, n),
                          rng.random(n) < 0.02, np.arange(n) % 100 == 99),
                     {})
    return out
