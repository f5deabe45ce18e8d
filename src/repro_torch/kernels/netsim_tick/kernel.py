"""The fused netsim tick as a hand-written CUDA kernel: build, binding, wrapper.

``csrc/netsim_tick.cu`` replaces the reference's Pallas ``_tick_kernel``
(``src/repro/kernels/netsim_tick/kernel.py:339``).  It is compiled with
``nvcc`` for ``sm_90a`` at first use into ``build/`` beside this file (a
directory git ignores), loaded with ``ctypes`` and launched on PyTorch's
current stream.  Nothing is built or imported from CUDA when this module is
imported.

:func:`netsim_tick` is the one entry point: on CPU tensors it runs the
plain torch version (:func:`.ref.hot_tick`); on CUDA tensors it launches
the kernel or raises.  ``netsim_tick.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .ref import TickOut, hot_tick

__all__ = ["TickOut", "netsim_tick", "build", "SMEM_LIMIT"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "netsim_tick.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# dynamic shared memory one block may use on Hopper (bytes)
SMEM_LIMIT = 232448
POLICIES = ("proportional", "pq")

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the netsim_tick CUDA kernel is "
                       "built on a machine with the CUDA toolkit")


def build() -> tuple[ctypes.CDLL, str]:
    """Compile (once per source version) and load the kernel library.
    Returns ``(library, compiler log)``; the log holds ptxas's register
    and shared-memory report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    if tag in _loaded:
        return _loaded[tag]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"netsim_tick_{tag}.so"
    log = ""
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.netsim_tick_launch.argtypes = [p] * 38 + [i] * 9 + [f, f, i, i, p]
    lib.netsim_tick_launch.restype = ctypes.c_int
    lib.netsim_tick_smem_bytes.argtypes = [i] * 5
    lib.netsim_tick_smem_bytes.restype = ctypes.c_size_t
    _loaded[tag] = (lib, log)
    return lib, log


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"netsim_tick: {name} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"netsim_tick: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"netsim_tick: {name} must have shape {tuple(shape)}"
                         f", got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"netsim_tick: {name} is on {x.device}, "
                         f"expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"netsim_tick: {name} must be contiguous")


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
    lib, _ = build()
    smem = lib.netsim_tick_smem_bytes(FW, H, L1, J, DJ)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"netsim_tick: one lane needs {smem} bytes of shared memory "
            f"(limit {SMEM_LIMIT}); fabrics this large need the tiled "
            "kernel, a later slice of the port")
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
    ptrs = [x.data_ptr() for x in (*operands, *out, ws_wire, ws_f)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.netsim_tick_launch(
        *ptrs, B, F, FW // F, H, P, L1, J, SEG, DJ, float(dt), float(mtu),
        int(bool(per_step_ecmp)), int(policy == "pq"), stream)
    if rc != 0:
        raise RuntimeError(f"netsim_tick kernel launch failed: CUDA error {rc}")
    netsim_tick.launches += 1
    return out


netsim_tick.launches = 0
