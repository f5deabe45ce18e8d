"""The flash attention forward as a hand-written CUDA kernel: binding, wrapper.

``csrc/flash_fwd.cu`` replaces the reference's Pallas ``_fwd_kernel``
(``src/repro/kernels/flash_attention/kernel.py:44``).  It is registered
with :mod:`repro_torch.kernels._build` like the netsim and switch
libraries, compiled at first use (or by ``build_all()``) for ``sm_90a``
with the shared flags, loaded with ``ctypes`` and launched on PyTorch's
current stream.

:func:`flash_fwd` is the one entry point: on CPU tensors it runs the plain
torch version (:func:`.ref.attention_ref`); on CUDA tensors it launches the
kernel or raises.  ``flash_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build
from .ref import attention_ref

__all__ = ["flash_fwd", "build", "BLOCK", "MAX_HEAD_DIM"]

CSRC = Path(__file__).resolve().parent / "csrc"
BLOCK = 128            # the reference's sequence block: S must be a multiple
MAX_HEAD_DIM = 128
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.flash_fwd_launch.argtypes = [p] * 6 + [ctypes.c_float, ctypes.c_int,
                                               p]
    lib.flash_fwd_launch.restype = ctypes.c_int


_build.register("flash_fwd", CSRC, _bind)


def build() -> tuple[ctypes.CDLL, str]:
    """The loaded kernel library, compiled first if need be."""
    return _build.build("flash_fwd")


def _check(q, k, v) -> None:
    if not all(isinstance(x, torch.Tensor) for x in (q, k, v)):
        raise TypeError("flash_fwd: q, k and v must be tensors")
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"flash_fwd: q, k, v must all be [BH, S, D] or all "
                         f"[B, H, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or k.shape[:-3] != q.shape[:-3] or \
            k.shape[-2:] != q.shape[-2:]:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    hq, hkv = q.shape[-3], k.shape[-3]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_fwd: {hq} query rows are not a multiple of "
                         f"{hkv} KV rows")
    S, D = q.shape[-2:]
    if S % BLOCK:
        raise ValueError(f"flash_fwd: sequence length {S} is not a multiple "
                         f"of {BLOCK} (the reference kernel leaves the tail "
                         "rows unwritten there)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_fwd: q, k and v are on different devices")


def flash_fwd(q, k, v, *, window: int = 0, causal: bool = True):
    """Softmax attention with scale ``1/sqrt(D)``, causal mask and optional
    sliding window (``kpos > qpos - window``).

    q: [BH, S, D] with k/v [BHkv, S, D] (query row ``b`` reads KV row
    ``b // group``), or q: [B, Hq, S, D] with k/v [B, Hkv, S, D] (head ``h``
    reads KV head ``h // group``); the 4-D form may be any strided view
    with a unit last stride, such as ``x.transpose(1, 2)`` of ``[B, S, H,
    D]`` activations, which the kernel reads in place.  ``S`` must be a
    multiple of 128.  Returns (o shaped and strided like q, in q's dtype;
    lse [BH, S] or [B, Hq, S] float32).
    """
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        if q.dim() == 3:
            return attention_ref(q, k, v, window=window, causal=causal)
        o, lse = attention_ref(q.flatten(0, 1), k.flatten(0, 1),
                               v.flatten(0, 1), window=window, causal=causal)
        return o.unflatten(0, q.shape[:2]), lse.unflatten(0, q.shape[:2])
    if dev.type != "cuda":
        raise ValueError(f"flash_fwd runs on cpu or cuda tensors, not {dev}")
    D = q.shape[-1]
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd: head dim {D} must be a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    o = torch.empty_like(q)       # keeps q's strides (a dense view)
    q4, k4, v4, o4 = (x.unsqueeze(0) if x.dim() == 3 else x
                      for x in (q, k, v, o))
    B, Hq, S, _ = q4.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    item = q.element_size()
    strides = []
    for name, x in (("q", q4), ("k", k4), ("v", v4), ("o", o4)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash_fwd: {name} needs a unit stride along "
                             "the head dim")
        if x.data_ptr() % 16 or any(s * item % 16 for s in x.stride()[:3]):
            raise ValueError(f"flash_fwd: {name} must be 16-byte aligned "
                             f"with 16-byte strides; strides {x.stride()}")
        strides += list(x.stride()[:3])
    dims = (ctypes.c_longlong * 19)(B, Hq, k4.shape[1], S, D, *strides,
                                    int(window), int(bool(causal)))
    lib, _ = build()
    rc = lib.flash_fwd_launch(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                              o4.data_ptr(), lse.data_ptr(), dims,
                              1.0 / math.sqrt(D), _DTYPES[q.dtype],
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd.launches += 1
    return o, (lse[0] if q.dim() == 3 else lse)


flash_fwd.launches = 0
