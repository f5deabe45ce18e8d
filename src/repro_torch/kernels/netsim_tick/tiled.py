"""The netsim tick tiled over the instance axis as a hand-written CUDA kernel.

``csrc/netsim_tiled.cu`` replaces the reference's Pallas
``_tiled_tick_kernel`` (``src/repro/kernels/netsim_tick/kernel.py:374``),
the ``segsum="onehot"`` tick with ``blk``: a grid of (``blk``-instance
blocks) x (lanes) that runs the reference's four sweeps as four launches in
stream order, keeps per-block partials of every float sum in a global
workspace and folds them in ascending block order, then flushes the link
and Symphony rows with one block per lane.  The first sweep sorts each
block's active (instance, hop) entries by link row and by Symphony row (a
stable counting sort, kept in the workspace); the later sweeps fold each
row's segment of those lists.  :func:`~.kernel.build_all` compiles it
beside the other two kernels.

:func:`netsim_tiled` is the one entry point: on CPU tensors it runs the
plain torch version (:func:`.ref.tiled_tick_ref`); on CUDA tensors it
launches the kernel or raises.  ``netsim_tiled.launches`` counts calls that
launched it (each call is the four sweeps and the flush of one tick).
"""
from __future__ import annotations

import ctypes

import torch

from ...core.netsim.params import PackedTables
from .._build import count_launch
from .kernel import POLICIES, SMEM_LIMIT, THREADS, TickOut, _check, build
from .ref import tiled_tick_ref

__all__ = ["netsim_tiled", "tiled_smem_bytes"]

_N_PTRS = 50
# the library's interface (netsim_tiled_abi() in the source)
ABI = 2


def tiled_smem_bytes(L1: int, J: int, DJ: int) -> int:
    """Shared bytes of the most demanding sweep, as
    ``netsim_tiled_smem_bytes`` in ``csrc/netsim_tiled.cu``: sweep 0's job
    row, link and Symphony row counts and offsets and two ints per warp,
    or sweep 2's three link-scale rows."""
    return max(4 * (J + 2 * L1 + 1 + 2 * DJ + 1 + 2 * (THREADS // 32)),
               4 * 3 * L1)


def netsim_tiled(step, sent, rate, done_upto, q_prev,
                 s_stepmin, s_psnwin, s_alpha, s_cnt, s_cntop,
                 cap, bg_base, bg_amp,
                 inst_job, inst_flow, sps, phase, nph, off,
                 tables: PackedTables, iscal, fscal, *, n_jobs: int,
                 blk: int, dt: float, mtu: float, per_step_ecmp: bool,
                 policy: str = "proportional") -> TickOut:
    """One tick of the netsim hot path for ``B`` lanes over ``blk``-instance
    blocks (``blk >= FW`` is one block: the untiled ``onehot`` tick).

    Per-lane operands lead with the lane axis, as for
    :func:`.kernel.netsim_tick`: instance state ``[B, FW]``, ``done_upto``
    ``[B, F]``, link rows ``[B, L+1]``, Symphony rows ``[B, DJ]``, ``iscal``
    ``[B, 5]``, ``fscal`` ``[B, 7]``.  The index arrays ``inst_job`` ...
    ``off`` are ``[FW]`` i32, shared by all lanes.  ``tables`` holds the
    lane-batched packed route tables (``chunk`` ``[B, FW, SEG]`` f32,
    ``routes``/``route_dom`` ``[B, FW, H]``, ``cand``/``cand_dom`` ``[B, FW,
    P, H]``, ``n_paths`` ``[B, FW]``, all i32); ``n_jobs`` is ``J``.
    """
    if policy not in POLICIES:
        raise ValueError(f"kernel share policy must be one of {POLICIES}, "
                         f"got {policy!r}")
    if step.dim() != 2:
        raise ValueError(f"netsim_tiled: step must be [B, FW], got "
                         f"{tuple(step.shape)}")
    blk = int(blk)
    if blk < 1:
        raise ValueError(f"blk must be >= 1, got {blk}")
    dev = step.device
    B, FW = (int(s) for s in step.shape)
    F = int(done_upto.shape[-1])
    if F < 1 or FW % F:
        raise ValueError(f"netsim_tiled: FW={FW} is not a multiple of F={F}")
    J = int(n_jobs)
    H = int(tables.routes.shape[-1])
    P = int(tables.cand.shape[2]) if tables.cand.dim() == 4 else -1
    SEG = int(tables.chunk.shape[-1])
    L1 = int(cap.shape[-1])
    DJ = int(s_stepmin.shape[-1])
    if J < 1 or DJ % J:
        raise ValueError(f"netsim_tiled: {DJ} Symphony rows are not a "
                         f"multiple of n_jobs={J}")
    i32, f32 = torch.int32, torch.float32
    lane = [
        ("step", step, i32, (B, FW)), ("sent", sent, f32, (B, FW)),
        ("rate", rate, f32, (B, FW)), ("done_upto", done_upto, i32, (B, F)),
        ("q_prev", q_prev, f32, (B, L1)),
        ("s_stepmin", s_stepmin, i32, (B, DJ)),
        ("s_psnwin", s_psnwin, f32, (B, DJ)),
        ("s_alpha", s_alpha, f32, (B, DJ)), ("s_cnt", s_cnt, f32, (B, DJ)),
        ("s_cntop", s_cntop, f32, (B, DJ)), ("cap", cap, f32, (B, L1)),
        ("bg_base", bg_base, f32, (B, L1)), ("bg_amp", bg_amp, f32, (B, L1)),
        ("inst_job", inst_job, i32, (FW,)),
        ("inst_flow", inst_flow, i32, (FW,)), ("sps", sps, i32, (FW,)),
        ("phase", phase, i32, (FW,)), ("nph", nph, i32, (FW,)),
        ("off", off, i32, (FW,)),
        ("chunk", tables.chunk, f32, (B, FW, SEG)),
        ("routes", tables.routes, i32, (B, FW, H)),
        ("route_dom", tables.route_dom, i32, (B, FW, H)),
        ("cand", tables.cand, i32, (B, FW, P, H)),
        ("cand_dom", tables.cand_dom, i32, (B, FW, P, H)),
        ("n_paths", tables.n_paths, i32, (B, FW)),
        ("iscal", iscal, i32, (B, 5)), ("fscal", fscal, f32, (B, 7)),
    ]
    for name, x, dtype, shape in lane:
        _check(name, x, dtype, shape, dev, "netsim_tiled")
    operands = [x for _, x, _, _ in lane]
    if dev.type == "cpu":
        return tiled_tick_ref(
            *operands[:19], tables, iscal, fscal, n_jobs=J, blk=blk, dt=dt,
            mtu=mtu, per_step_ecmp=per_step_ecmp, policy=policy)
    if dev.type != "cuda":
        raise ValueError(f"netsim_tiled runs on cpu or cuda tensors, not "
                         f"{dev}")
    lib, _ = build("netsim_tiled")
    smem = lib.netsim_tiled_smem_bytes(L1, J, DJ)
    if smem != tiled_smem_bytes(L1, J, DJ):
        raise RuntimeError(f"netsim_tiled: the library sizes shared memory "
                           f"at {smem} bytes, the wrapper at "
                           f"{tiled_smem_bytes(L1, J, DJ)}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"netsim_tiled: {L1} link rows and {DJ} Symphony "
                         f"rows need {smem} bytes of shared memory a block "
                         f"(limit {SMEM_LIMIT})")
    blk = min(blk, FW)
    if blk > 65536:
        raise ValueError(f"netsim_tiled: blocks of {blk} instances exceed "
                         "the kernel's uint16 entry lists (at most 65,536)")
    NB = -(-FW // blk)
    out = TickOut(
        iroute=torch.empty(B, FW, H, dtype=i32, device=dev),
        eff=torch.empty(B, FW, dtype=f32, device=dev),
        offered=torch.empty(B, L1, dtype=f32, device=dev),
        q=torch.empty(B, L1, dtype=f32, device=dev),
        p_red=torch.empty(B, L1, dtype=f32, device=dev),
        s_stepmin=torch.empty(B, DJ, dtype=i32, device=dev),
        s_psnwin=torch.empty(B, DJ, dtype=f32, device=dev),
        s_alpha=torch.empty(B, DJ, dtype=f32, device=dev),
        s_cnt=torch.empty(B, DJ, dtype=f32, device=dev),
        s_cntop=torch.empty(B, DJ, dtype=f32, device=dev))
    ws = (torch.empty(B, FW, H, dtype=i32, device=dev),        # ws_dom
          torch.empty(B, FW, dtype=i32, device=dev),           # ws_wire
          torch.empty(B, FW, dtype=torch.uint8, device=dev),   # ws_flags
          torch.empty(B, FW, dtype=f32, device=dev),           # ws_f
          torch.empty(B, NB, 3, L1, dtype=f32, device=dev),    # p_link
          torch.empty(B, NB, J, dtype=i32, device=dev),        # p_job
          torch.empty(B, NB, 3, DJ, dtype=f32, device=dev),    # p_symf
          torch.empty(B, NB, 2, DJ, dtype=i32, device=dev),    # p_symi
          # each block's active instances and its entries sorted by link
          # row and by Symphony row (uint16), and the rows' offsets
          torch.empty(B, NB, blk, dtype=torch.int16, device=dev),
          torch.empty(B, NB, blk * H, dtype=torch.int16, device=dev),
          torch.empty(B, NB, blk * H, dtype=torch.int16, device=dev),
          torch.empty(B, NB, L1 + 1, dtype=i32, device=dev),
          torch.empty(B, NB, DJ + 1, dtype=i32, device=dev))
    tensors = [*operands, *out, *ws]
    assert len(tensors) == _N_PTRS
    ptrs = (ctypes.c_void_p * _N_PTRS)(*(x.data_ptr() for x in tensors))
    dims = (ctypes.c_int * 13)(B, F, FW // F, H, P, L1, J, SEG, DJ, blk, NB,
                               int(bool(per_step_ecmp)),
                               int(policy == "pq"))
    fdims = (ctypes.c_float * 2)(float(dt), float(mtu))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.netsim_tiled_launch(ptrs, dims, fdims, stream)
    if rc != 0:
        raise RuntimeError(f"netsim_tiled kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(netsim_tiled)
    return out


netsim_tiled.launches = 0
