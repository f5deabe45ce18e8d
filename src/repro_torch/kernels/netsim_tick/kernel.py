"""The fused netsim tick as a hand-written CUDA kernel: build, binding, wrapper.

``csrc/netsim_tick.cu`` replaces the reference's Pallas ``_tick_kernel``
(``src/repro/kernels/netsim_tick/kernel.py:339``).  Each ``csrc/*.cu``
source is compiled with ``nvcc`` for ``sm_90a`` at first use into its own
shared library in ``build/`` beside this file (a directory git ignores),
loaded with ``ctypes`` and launched on PyTorch's current stream;
:func:`build_all` compiles them in parallel (``kernels/_build.py``).
Nothing is built or imported from CUDA when this module is imported.

:func:`netsim_tick` is the one entry point: on CPU tensors it runs the
plain torch version (:func:`.ref.hot_tick`); on CUDA tensors it launches
the kernel or raises.  ``netsim_tick.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from .. import _build
from .._build import SMEM_LIMIT, count_launch
from .ref import TickOut, hot_tick

__all__ = ["TickOut", "netsim_tick", "build", "build_all", "kernel_policy",
           "SMEM_LIMIT", "hot_smem_split", "HotSplit", "THREADS"]

CSRC = Path(__file__).resolve().parent / "csrc"
POLICIES = ("proportional", "pq")


def _bind_tick(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.netsim_tick_launch.argtypes = [p] * 39 + [i] * 9 + [f, f, i, i, i, p]
    lib.netsim_tick_launch.restype = ctypes.c_int
    lib.netsim_tick_smem_bytes.argtypes = [i] * 6
    lib.netsim_tick_smem_bytes.restype = ctypes.c_size_t


def _bind_window(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.netsim_window_launch.argtypes = [p, p, p, p]
    lib.netsim_window_launch.restype = ctypes.c_int
    lib.netsim_window_smem_bytes.argtypes = [i] * 7
    lib.netsim_window_smem_bytes.restype = ctypes.c_size_t
    lib.netsim_math_launch.argtypes = [p, p, p, i, p]
    lib.netsim_math_launch.restype = ctypes.c_int


def _bind_tiled(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.netsim_tiled_launch.argtypes = [p, p, p, p]
    lib.netsim_tiled_launch.restype = ctypes.c_int
    lib.netsim_tiled_smem_bytes.argtypes = [i] * 3
    lib.netsim_tiled_smem_bytes.restype = ctypes.c_size_t
    lib.netsim_tiled_abi.argtypes = []
    lib.netsim_tiled_abi.restype = i


# one shared library per source in csrc/, and the function that binds it
LIBRARIES = {"netsim_tick": _bind_tick, "netsim_window": _bind_window,
             "netsim_tiled": _bind_tiled}
for _name, _bind in LIBRARIES.items():
    _build.register(_name, CSRC, _bind)


def kernel_policy(cfg) -> str:
    """The in-kernel share policy for this config ("proportional"|"pq")."""
    if cfg.share_policy == "pq" or cfg.pq_lanes == "all":
        return "pq"
    return "proportional"


def build_all(names=tuple(LIBRARIES)) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile the netsim tick libraries that are not built yet (one
    ``nvcc`` per source, all started together) and load them; see
    :func:`repro_torch.kernels._build.build_all`."""
    return _build.build_all(names)


def build(name: str = "netsim_tick") -> tuple[ctypes.CDLL, str]:
    """The loaded kernel library ``name``, compiled first if need be.
    Returns ``(library, compiler log)``."""
    return _build.build(name)


def _round16(n: int) -> int:
    return (n + 15) & ~15


# threads and warps of a tick or window block (NT_THREADS, NT_WARPS of
# csrc/netsim_hot.cuh)
THREADS = 512
WARPS = THREADS // 32


class HotSplit(NamedTuple):
    """Where one lane's hot-stage scratch lives: ``smem`` bytes of shared
    memory per block; ``ids`` bytes per lane of global workspace for the
    link ids, the entry list and the flags (0 when they fit in shared
    memory); ``ws`` bytes per lane of global workspace in all: the
    active-instance list, then those ids."""
    smem: int
    ids: int
    ws: int


def hot_smem_split(FW: int, H: int, L1: int, J: int, DJ: int,
                   extra: int = 0) -> HotSplit:
    """The split of ``csrc/netsim_hot.cuh``: the link, job and Symphony
    rows, the row sorts' counts and offsets and two ints per warp (and
    ``extra`` bytes of a kernel's own rows) always take shared memory; the
    uint16 link id and the uint16 sorted-list slot of every (instance, hop)
    and the flag byte of every instance follow them there when everything
    fits in :data:`SMEM_LIMIT`, and take the per-lane global workspace
    otherwise.  The active-instance list (uint16) always takes the start of
    that workspace.  Mirrors ``hot_rows_bytes``/``hot_ids_raw``/
    ``hot_act_bytes``/``hot_ws_bytes``/``hot_smem_bytes`` of the header."""
    if FW > 65536:
        raise ValueError(f"{FW} instances a lane exceed the kernels' uint16 "
                         "instance ids")
    rows = 4 * (8 * L1 + J + 4 * DJ + 2 + 2 * WARPS)
    ids = 4 * ((FW * H + 1) & ~1) + FW
    act = _round16(4 * ((FW + 1) // 2))
    if _round16(rows) + extra > SMEM_LIMIT:
        raise ValueError(
            f"one lane's {L1} link rows and {DJ} Symphony rows need "
            f"{_round16(rows) + extra} bytes of shared memory (limit "
            f"{SMEM_LIMIT})")
    if _round16(rows + ids) + extra <= SMEM_LIMIT:
        return HotSplit(_round16(rows + ids) + extra, 0, act)
    return HotSplit(_round16(rows) + extra, _round16(ids),
                    act + _round16(ids))


def ids_workspace(B: int, split: HotSplit, device) -> torch.Tensor:
    """The per-lane global workspace of a split."""
    return torch.empty(B, split.ws, dtype=torch.uint8, device=device)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, who: str = "netsim_tick") -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must have shape {tuple(shape)}"
                         f", got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{who}: {name} is on {x.device}, "
                         f"expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def netsim_tick(step, sent, rate, done_upto, q_prev,
                s_stepmin, s_psnwin, s_alpha, s_cnt, s_cntop,
                routes, path_table, n_paths, cap, link_dom, bg_base, bg_amp,
                inst_job, inst_flow, sps, phase, nph, off, chunk_sched,
                iscal, fscal, *, dt: float, mtu: float, per_step_ecmp: bool,
                policy: str = "proportional") -> TickOut:
    """One fused tick of the netsim hot path for ``B`` lanes.

    Per-lane operands lead with the lane axis: instance state ``[B, FW]``
    (step i32, sent/rate f32), ``done_upto`` ``[B, F]`` i32, link state
    ``[B, L+1]``, Symphony rows ``[B, DJ]`` (stepmin i32, the rest f32),
    routes ``[B, F, H]``, ``path_table`` ``[B, F, P, H]``, ``n_paths``
    ``[B, F]``, ``link_dom`` ``[B, L+1]`` (all i32), ``cap``/``bg_base``/
    ``bg_amp`` ``[B, L+1]`` f32, ``iscal`` ``[B, 5]`` i32 = ``[tick, seed,
    bg_period_ticks, sym_win_ticks, pq_on]`` and ``fscal`` ``[B, 7]`` f32 =
    ``[bg_duty, red_kmin, red_kmax, red_pmax, tau, n_sample, alpha_max]``.
    Shared by all lanes: ``inst_job``, ``inst_flow``, ``sps``, ``phase``,
    ``nph``, ``off`` ``[FW]`` i32 and ``chunk_sched`` ``[J, SEG]`` f32.
    """
    if policy not in POLICIES:
        raise ValueError(f"kernel share policy must be one of {POLICIES}, "
                         f"got {policy!r}")
    dev = step.device
    if step.dim() != 2:
        raise ValueError(f"netsim_tick: step must be [B, FW], got "
                         f"{tuple(step.shape)}")
    B, FW = (int(s) for s in step.shape)
    F = int(done_upto.shape[-1])
    if F < 1 or FW % F:
        raise ValueError(f"netsim_tick: FW={FW} is not a multiple of F={F}")
    H = int(routes.shape[-1])
    P = int(path_table.shape[2]) if path_table.dim() == 4 else -1
    L1 = int(cap.shape[-1])
    DJ = int(s_stepmin.shape[-1])
    J, SEG = (int(s) for s in chunk_sched.shape) \
        if chunk_sched.dim() == 2 else (-1, -1)
    i32, f32 = torch.int32, torch.float32
    spec = [
        ("step", step, i32, (B, FW)), ("sent", sent, f32, (B, FW)),
        ("rate", rate, f32, (B, FW)), ("done_upto", done_upto, i32, (B, F)),
        ("q_prev", q_prev, f32, (B, L1)),
        ("s_stepmin", s_stepmin, i32, (B, DJ)),
        ("s_psnwin", s_psnwin, f32, (B, DJ)),
        ("s_alpha", s_alpha, f32, (B, DJ)), ("s_cnt", s_cnt, f32, (B, DJ)),
        ("s_cntop", s_cntop, f32, (B, DJ)),
        ("routes", routes, i32, (B, F, H)),
        ("path_table", path_table, i32, (B, F, P, H)),
        ("n_paths", n_paths, i32, (B, F)), ("cap", cap, f32, (B, L1)),
        ("link_dom", link_dom, i32, (B, L1)),
        ("bg_base", bg_base, f32, (B, L1)), ("bg_amp", bg_amp, f32, (B, L1)),
        ("inst_job", inst_job, i32, (FW,)), ("inst_flow", inst_flow, i32, (FW,)),
        ("sps", sps, i32, (FW,)), ("phase", phase, i32, (FW,)),
        ("nph", nph, i32, (FW,)), ("off", off, i32, (FW,)),
        ("chunk_sched", chunk_sched, f32, (J, SEG)),
        ("iscal", iscal, i32, (B, 5)), ("fscal", fscal, f32, (B, 7)),
    ]
    for name, x, dtype, shape in spec:
        _check(name, x, dtype, shape, dev)
    kw = dict(dt=dt, mtu=mtu, per_step_ecmp=per_step_ecmp, policy=policy)
    operands = [x for _, x, _, _ in spec]
    if dev.type == "cpu":
        return hot_tick(*operands, **kw)
    if dev.type != "cuda":
        raise ValueError(f"netsim_tick runs on cpu or cuda tensors, not {dev}")
    if L1 > 65535:
        raise ValueError(f"netsim_tick: {L1} link rows exceed the kernel's "
                         "uint16 link ids")
    lib, _ = build("netsim_tick")
    split = hot_smem_split(FW, H, L1, J, DJ)
    smem = lib.netsim_tick_smem_bytes(FW, H, L1, J, DJ, int(not split.ids))
    if smem != split.smem:
        raise RuntimeError(f"netsim_tick: the library sizes shared memory "
                           f"at {smem} bytes, the wrapper at {split.smem}")
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
    ws_wire = torch.empty(B, FW, dtype=i32, device=dev)
    ws_f = torch.empty(B, FW, dtype=f32, device=dev)
    ws_ids = ids_workspace(B, split, dev)
    ptrs = [x.data_ptr() for x in (*operands, *out, ws_wire, ws_f, ws_ids)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.netsim_tick_launch(
        *ptrs, B, F, FW // F, H, P, L1, J, SEG, DJ, float(dt), float(mtu),
        int(bool(per_step_ecmp)), int(policy == "pq"), int(not split.ids),
        stream)
    if rc != 0:
        raise RuntimeError(f"netsim_tick kernel launch failed: CUDA error {rc}")
    count_launch(netsim_tick)
    return out


netsim_tick.launches = 0
