"""The multi-tick netsim window as a hand-written CUDA kernel: binding, wrapper.

``csrc/netsim_window.cu`` replaces the reference's Pallas
``_window_kernel`` (``src/repro/kernels/netsim_tick/window.py:64``): ``n``
whole engine ticks per launch, one thread block per lane, the per-instance
state carried in place in the output buffers and the threefry coin flips
drawn in the kernel.  :func:`~.kernel.build_all` compiles it beside the
single-tick kernel.

:func:`netsim_window` is the one entry point: on CPU tensors it runs the
plain torch version (:func:`.ref.window_ref`, ``n`` eager ticks); on CUDA
tensors it launches the kernel or raises.  It never changes the state it is
given.  ``netsim_window.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.netsim.stages import EngineState
from .._build import count_launch
from .kernel import (POLICIES, _check, build, hot_smem_split,
                     ids_workspace, kernel_policy)
from .ref import window_ref

__all__ = ["netsim_window", "window_operands", "kernel_math",
           "window_smem_split"]

# WLArrays fields the kernel reads, in csrc/netsim_window.cu's order
_WL_FIELDS = ("pred", "job", "phase", "sps", "pass_steps", "total_steps",
              "n_phases", "n_segs", "chunk_sched", "gap_ticks",
              "fstart_ticks", "trig_job", "trig_seg", "trig_delay_ticks")
_CTX_FIELDS = ("inst_job", "inst_flow", "sps_i", "phase_i", "nph_i", "off_i")
_STATIC_FIELDS = ("routes", "path_table", "n_paths", "cap", "link_dom",
                  "bg_base", "bg_amp")
_N_PTRS = 79


def window_operands(ctx, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-lane knob rows of the window kernel: ``iscal`` ``[B, 8]`` i32
    = ``[seed, bg_period_ticks, sym_win_ticks, pq_on, cc_epoch_ticks,
    cc_fr_stages, sym_on, sym_start_tick]`` and ``fscal`` ``[B, 13]`` f32 =
    ``[bg_duty, red_kmin, red_kmax, red_pmax, tau, n_sample, alpha_max,
    cc_g, cc_rai, cc_rhai, cc_min_rate, k, n_warmup]``."""
    st = ctx.st
    iscal = torch.stack([st.seed, st.bg_period_ticks, cfg.sym_win_ticks,
                         cfg.pq_on, cfg.cc_epoch_ticks, cfg.cc_fr_stages,
                         cfg.sym_on, cfg.sym_start_tick],
                        dim=1).to(torch.int32).contiguous()
    fscal = torch.stack([st.bg_duty, cfg.red_kmin, cfg.red_kmax,
                         cfg.red_pmax, cfg.sym.tau, cfg.sym.n_sample,
                         cfg.sym.alpha_max, cfg.cc_g, cfg.cc_rai, cfg.cc_rhai,
                         cfg.cc_min_rate, cfg.sym.k, cfg.sym.n_warmup],
                        dim=1).to(torch.float32).contiguous()
    return iscal, fscal


def window_smem_split(F: int, FW: int, H: int, L1: int, J: int, DJ: int):
    """Shared and global bytes one lane of the window kernel needs
    (:func:`.kernel.hot_smem_split` plus the window's own rows: two sets
    of Symphony rows, the RED profile, a flag per flow, six job rows and a
    float per warp, as ``win_rows_bytes`` in ``csrc/netsim_window.cu``)."""
    extra = 10 * DJ * 4 + L1 * 4 + F * 4 + 6 * J * 4 + 32 * 4
    return hot_smem_split(FW, H, L1, J, DJ, extra)


def netsim_window(ctx, cfg, state: EngineState, base_tick: int, n: int):
    """Run ``n`` engine ticks from ``base_tick`` for every lane of ``ctx``.

    Returns ``(state after n ticks, metric sample of tick base_tick+n-1)``
    with :func:`stages.engine_tick`'s state and sample layout.  ``cfg`` is
    the merged :class:`~repro_torch.core.netsim.params.EngineParams`; the
    kernel covers the ``proportional`` and ``pq`` share policies.  It adds
    every float sum in ascending (instance, hop) order, which is also one
    valid association under ``segsum="onehot"``'s allclose contract, so
    both modes run it unchanged.
    """
    n = int(n)
    base_tick = int(base_tick)
    if n < 1:
        raise ValueError(f"a window runs at least one tick, got n={n}")
    if cfg.share_policy not in POLICIES:
        raise ValueError(f"the window kernel's share policy must be one of "
                         f"{POLICIES}, got {cfg.share_policy!r}")
    dev = ctx.device
    if dev.type == "cpu":
        return window_ref(ctx, cfg, state, base_tick, n)
    if dev.type != "cuda":
        raise ValueError(f"netsim_window runs on cpu or cuda tensors, not "
                         f"{dev}")
    lib, _ = build("netsim_window")
    out = _launch(lib, ctx, cfg, state, base_tick, n)
    count_launch(netsim_window)
    return out


def _launch(lib, ctx, cfg, state: EngineState, base_tick: int, n: int):
    """Check the operands, allocate the outputs and launch the kernel of
    ``lib`` on the current stream; returns ``(state', sample)``."""
    dev = ctx.device
    B, F, W, J, H, L1, DJ = ctx.B, ctx.F, ctx.W, ctx.J, ctx.H, ctx.L + 1, \
        ctx.DJ
    FW = F * W
    st, wl = ctx.st, ctx.wl
    SEG = int(wl.chunk_sched.shape[1])
    P = int(st.path_table.shape[2])
    i32, f32 = torch.int32, torch.float32
    shapes = dict(next_step=(B, F), done_upto=(B, F), finish=(B, F),
                  step_of=(B, F, W), sent=(B, F, W), rate=(B, F, W),
                  target=(B, F, W), alpha_cc=(B, F, W), stage=(B, F, W),
                  lam=(B, F, W), q=(B, L1), s_stepmin=(B, DJ),
                  s_psnwin=(B, DJ), s_alpha=(B, DJ), s_cnt=(B, DJ),
                  s_cntop=(B, DJ), seg_idx=(B, J), seg_ready=(B, J),
                  job_finish=(B, J), key=(B, 2))
    ints = {"next_step", "done_upto", "finish", "step_of", "stage",
            "s_stepmin", "seg_idx", "seg_ready", "job_finish"}
    for name in EngineState._fields:
        dtype = torch.int64 if name == "key" else \
            (i32 if name in ints else f32)
        _check(name, getattr(state, name), dtype, shapes[name], dev,
               "netsim_window")
    wl_x = [getattr(wl, f) for f in _WL_FIELDS]
    ctx_x = [getattr(ctx, f) for f in _CTX_FIELDS]
    st_x = [getattr(st, f) for f in _STATIC_FIELDS]
    for name, x in zip(_WL_FIELDS + _CTX_FIELDS + _STATIC_FIELDS,
                       wl_x + ctx_x + st_x):
        _check(name, x, f32 if x.is_floating_point() else i32,
               tuple(x.shape), dev, "netsim_window")
    if L1 > 65535:
        raise ValueError(f"netsim_window: {L1} link rows exceed the kernel's "
                         "uint16 link ids")
    split = window_smem_split(F, FW, H, L1, J, DJ)
    smem = lib.netsim_window_smem_bytes(F, FW, H, L1, J, DJ,
                                        int(not split.ids))
    if smem != split.smem:
        raise RuntimeError(f"netsim_window: the library sizes shared memory "
                           f"at {smem} bytes, the wrapper at {split.smem}")
    iscal, fscal = window_operands(ctx, cfg)
    new = EngineState(*(torch.empty_like(x) for x in state))
    sample = (torch.empty(B, J, dtype=i32, device=dev),
              torch.empty(B, J, dtype=i32, device=dev),
              torch.empty(B, J, dtype=i32, device=dev),
              torch.empty(B, J, dtype=f32, device=dev),
              torch.empty(B, dtype=f32, device=dev),
              torch.empty(B, dtype=f32, device=dev))
    ws = (torch.empty(B, FW, dtype=i32, device=dev),
          torch.empty(B, FW, dtype=f32, device=dev),
          torch.empty(B, FW, dtype=f32, device=dev))
    tensors = [*state, *new, *wl_x, *ctx_x, *st_x, iscal, fscal, *sample,
               *ws, ids_workspace(B, split, dev)]
    assert len(tensors) == _N_PTRS
    ptrs = (ctypes.c_void_p * _N_PTRS)(*(x.data_ptr() for x in tensors))
    dims = (ctypes.c_int * 14)(
        B, F, W, H, P, L1, J, SEG, DJ, int(bool(cfg.per_step_ecmp)),
        int(kernel_policy(cfg) == "pq"), base_tick, n, int(not split.ids))
    fdims = (ctypes.c_float * 2)(float(cfg.dt), float(cfg.mtu))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.netsim_window_launch(ptrs, dims, fdims, stream)
    if rc != 0:
        raise RuntimeError(f"netsim_window kernel launch failed: CUDA error "
                           f"{rc}")
    return new, sample


netsim_window.launches = 0


def kernel_math(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(expf(x), log1pf(x))`` elementwise, computed by the window kernel
    library's own math functions on the card (for holding them against
    torch's ``exp``/``log1p``)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or \
            not x.is_contiguous():
        raise ValueError("kernel_math takes a contiguous float32 CUDA tensor")
    lib, _ = build("netsim_window")
    e, lp = torch.empty_like(x), torch.empty_like(x)
    rc = lib.netsim_math_launch(x.data_ptr(), e.data_ptr(), lp.data_ptr(),
                                x.numel(),
                                torch.cuda.current_stream(x.device)
                                .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"netsim_math kernel launch failed: CUDA error "
                           f"{rc}")
    return e, lp
