"""The Alg. 1 switch data plane as a hand-written CUDA kernel: binding, wrapper.

``csrc/switch_pipeline.cu`` replaces the reference's Pallas
``_pipeline_kernel`` (``src/repro/kernels/switch_pipeline/kernel.py:42``):
the per-packet Tofino2 analogue of the paper's prototype, whose walk over a
packet batch carries the Per-Job State Block.  The kernel computes that
walk as a parallel scan: tiles of ``TILE`` packets, three block scans with
decoupled look-backs over the tiles (step_min; psn_rec and the counts;
alpha), bit-equal to the walk.  It is built with the netsim kernels by
:func:`repro_torch.kernels._build.build_all`.

:func:`switch_pipeline` is the one entry point: on CPU tensors it runs the
plain torch version (:func:`.ref.pipeline_plain`); on CUDA tensors it
launches the kernel or raises.  ``switch_pipeline.launches`` counts calls
that launched it (one kernel launch a call, after a memset of the
look-back flags).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import pipeline_plain

__all__ = ["switch_pipeline", "build"]

CSRC = Path(__file__).resolve().parent / "csrc"
# packets a block of the kernel scans (SP_TILE in the source)
TILE = 2048
# the library's interface (switch_pipeline_abi() in the source)
ABI = 2


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.switch_pipeline_launch.argtypes = [p] * 10 + [i] + [f] * 5 + [i, p]
    lib.switch_pipeline_launch.restype = ctypes.c_int
    lib.switch_pipeline_ws_bytes.argtypes = [i]
    lib.switch_pipeline_ws_bytes.restype = ctypes.c_size_t
    lib.switch_pipeline_abi.argtypes = []
    lib.switch_pipeline_abi.restype = i


_build.register("switch_pipeline", CSRC, _bind)


def build() -> tuple[ctypes.CDLL, str]:
    """The loaded kernel library, compiled first if need be."""
    return _build.build("switch_pipeline")


def switch_pipeline(steps, psns, lasts, win_ends, uniforms, *, k=0.01,
                    tau=0.25, n_warmup=16, n_sample=32, alpha_max=64.0,
                    exact=True):
    """Process a packet batch through Alg. 1.  All inputs ``[P]``: steps,
    LAST bits and window-end flags int32, psns and uniform samples float32,
    on one device.  State starts at zero with ``alpha = 1`` on every call.
    ``exact=True`` marks with the float probability; ``exact=False`` with
    the log2-domain compare through the 16-entry LUT (the state walk is
    the same).  Returns ``(marks i32, step_min i32, psn_rec f32, alpha
    f32)`` per packet, the state after each packet."""
    dev = steps.device
    if steps.dim() != 1:
        raise ValueError(f"switch_pipeline: steps must be [P], got "
                         f"{tuple(steps.shape)}")
    P = int(steps.shape[0])
    for name, x, dtype in (("steps", steps, torch.int32),
                           ("psns", psns, torch.float32),
                           ("lasts", lasts, torch.int32),
                           ("win_ends", win_ends, torch.int32),
                           ("uniforms", uniforms, torch.float32)):
        if not isinstance(x, torch.Tensor) or x.dtype != dtype:
            raise TypeError(f"switch_pipeline: {name} must be a {dtype} "
                            "tensor")
        if tuple(x.shape) != (P,):
            raise ValueError(f"switch_pipeline: {name} must have shape "
                             f"({P},), got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"switch_pipeline: {name} is on {x.device}, "
                             f"expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"switch_pipeline: {name} must be contiguous")
    kw = dict(k=k, tau=tau, n_warmup=n_warmup, n_sample=n_sample,
              alpha_max=alpha_max, exact=exact)
    if dev.type == "cpu":
        return pipeline_plain(steps, psns, lasts, win_ends, uniforms, **kw)
    if dev.type != "cuda":
        raise ValueError(f"switch_pipeline runs on cpu or cuda tensors, not "
                         f"{dev}")
    lib, _ = build()
    out = (torch.empty(P, dtype=torch.int32, device=dev),
           torch.empty(P, dtype=torch.int32, device=dev),
           torch.empty(P, dtype=torch.float32, device=dev),
           torch.empty(P, dtype=torch.float32, device=dev))
    if P == 0:
        return out
    # the tile counter, the look-back flags (zeroed by the launch) and the
    # tiles' aggregate maps and inclusive states
    ws = torch.empty(lib.switch_pipeline_ws_bytes(P), dtype=torch.uint8,
                     device=dev)
    rc = lib.switch_pipeline_launch(
        *(x.data_ptr() for x in (steps, psns, lasts, win_ends, uniforms,
                                 *out, ws)),
        P, float(k), float(tau), float(n_warmup), float(n_sample),
        float(alpha_max), int(bool(exact)),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"switch_pipeline kernel launch failed: CUDA "
                           f"error {rc}")
    switch_pipeline.launches += 1
    return out


switch_pipeline.launches = 0
