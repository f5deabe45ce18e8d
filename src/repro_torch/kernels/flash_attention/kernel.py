"""The flash attention forward and backward as hand-written CUDA kernels:
bindings, wrappers.

``csrc/flash_fwd.cu`` replaces the reference's Pallas ``_fwd_kernel``
(``src/repro/kernels/flash_attention/kernel.py:44``); ``csrc/flash_bwd.cu``
its ``_dq_kernel`` and ``_dkv_kernel`` (``:124``, ``:159``).  Both share
``csrc/flash_common.cuh`` and ``csrc/hopper.cuh``, are registered with
:mod:`repro_torch.kernels._build` like the netsim and switch libraries,
compiled at first use (or by ``build_all()``) for ``sm_90a`` with the shared
flags, loaded with ``ctypes`` and launched on PyTorch's current stream.

:func:`flash_fwd` and :func:`flash_bwd` are the entry points: on CPU
tensors they run the plain torch versions (:func:`.ref.attention_ref`,
:func:`.ref.attention_bwd_ref`); on CUDA tensors they launch the kernels or
raise.  ``flash_fwd.launches``, ``flash_bwd.launches_dq`` and
``flash_bwd.launches_dkv`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build
from .ref import attention_bwd_ref, attention_ref

__all__ = ["flash_fwd", "flash_bwd", "BwdCall", "build", "BLOCK",
           "MAX_HEAD_DIM", "FWD_TILE", "DQ_TILE", "DKV_TILE",
           "visible_tiles", "tile_kind", "fwd_kernel_info",
           "bwd_kernel_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BLOCK = 128            # the reference's sequence block: S must be a multiple
MAX_HEAD_DIM = 128
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# The bf16 kernels' tiles: (query rows, keys).  Forward (csrc/flash_fwd.cu)
# and dq (csrc/flash_bwd.cu): a block of 128 query rows (64 a consumer
# warpgroup) walks stages of 128 and of 64 keys; dk/dv: a block of 128 keys
# walks stages of 64 query rows.
FWD_TILE = (128, 128)
DQ_TILE = (128, 64)
DKV_TILE = (64, 128)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.flash_fwd_launch.argtypes = [p] * 6 + [ctypes.c_float, ctypes.c_int,
                                               p]
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_fwd_kernel_info.argtypes = [ctypes.c_int] * 2 + [p]
    lib.flash_fwd_kernel_info.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    tail = [p, ctypes.c_float, ctypes.c_int, p]       # dims, scale, dtype,
    lib.flash_bwd_dq_launch.argtypes = [p] * 7 + tail  # stream
    lib.flash_bwd_dq_launch.restype = ctypes.c_int
    lib.flash_bwd_dkv_launch.argtypes = [p] * 8 + tail
    lib.flash_bwd_dkv_launch.restype = ctypes.c_int
    lib.flash_bwd_kernel_info.argtypes = [ctypes.c_int] * 3 + [p]
    lib.flash_bwd_kernel_info.restype = ctypes.c_int


_build.register("flash_fwd", CSRC, _bind)
_build.register("flash_bwd", CSRC, _bind_bwd)


def build() -> tuple[ctypes.CDLL, str]:
    """The loaded forward library, compiled first if need be."""
    return _build.build("flash_fwd")


def visible_tiles(kind: str, index: int, S: int, window: int = 0,
                  causal: bool = True) -> tuple[int, int]:
    """The first and last tile a bf16 block walks, as the kernels compute
    them (``key_tiles`` in ``csrc/flash_fwd.cu``, ``key_tiles``/
    ``query_tiles`` in ``csrc/flash_bwd.cu``): for ``kind="fwd"`` the
    128-key tiles that forward query block ``index`` (128 rows) can see, for
    ``kind="dq"`` the 64-key tiles of dq block ``index`` (128 rows), for
    ``kind="dkv"`` the 64-row query tiles that can see key block ``index``
    (128 keys).  Tiles in between may still be wholly masked for one
    consumer's 64 rows (:func:`tile_kind`): the backward kernels skip those,
    the forward masks them."""
    if kind in ("fwd", "dq"):
        rows, keys = FWD_TILE if kind == "fwd" else DQ_TILE
        q0 = index * rows
        last = min(S - 1, q0 + rows - 1) if causal else S - 1
        first = max(0, q0 - window + 1) if window else 0
        return first // keys, last // keys
    if kind == "dkv":
        rows, keys = DKV_TILE
        k0 = index * keys
        first = k0 if causal else 0
        last = min(S - 1, k0 + keys - 1 + window - 1) if window else S - 1
        return first // rows, last // rows
    raise ValueError(f"visible_tiles: kind is 'fwd', 'dq' or 'dkv', not "
                     f"{kind!r}")


def tile_kind(qa: int, qb: int, ka: int, kb: int, window: int = 0,
              causal: bool = True) -> str:
    """Whether query rows ``[qa, qb]`` see ``"none"``, ``"some"`` or
    ``"all"`` of keys ``[ka, kb]`` (``tile_kind`` in
    ``csrc/flash_common.cuh``): the kernels run the element mask only on
    tiles that are not ``"all"``."""
    if (causal and ka > qb) or (window and kb <= qa - window):
        return "none"
    if (not causal or kb <= qa) and (not window or ka > qb - window):
        return "all"
    return "some"


def _kernel_info(lib: ctypes.CDLL, fn: str, *args) -> dict[str, int]:
    out = (ctypes.c_int * 4)()
    rc = getattr(lib, fn)(*args, out)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads"),
                    out))


def fwd_kernel_info(dtype: torch.dtype, head_dim: int) -> dict[str, int]:
    """What the compiler made of the forward kernel for ``dtype`` and
    ``head_dim``: registers and local (spill) bytes a thread, dynamic shared
    memory and threads a block.  Builds the library if need be (on a
    machine with the CUDA toolkit)."""
    return _kernel_info(build()[0], "flash_fwd_kernel_info", _DTYPES[dtype],
                        head_dim)


def bwd_kernel_info(which: str, dtype: torch.dtype, head_dim: int
                    ) -> dict[str, int]:
    """What the compiler made of a backward kernel (``which`` "dq" or
    "dkv") for ``dtype`` and ``head_dim``: registers and local (spill)
    bytes a thread, dynamic shared memory and threads a block.  Builds the
    library if need be (on a machine with the CUDA toolkit)."""
    return _kernel_info(_build.build("flash_bwd")[0], "flash_bwd_kernel_info",
                        {"dq": 0, "dkv": 1}[which], _DTYPES[dtype], head_dim)


def _check(q, k, v, fn: str = "flash_fwd") -> None:
    if not all(isinstance(x, torch.Tensor) for x in (q, k, v)):
        raise TypeError(f"{fn}: q, k and v must be tensors")
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"{fn}: q, k, v must all be [BH, S, D] or all "
                         f"[B, H, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or k.shape[:-3] != q.shape[:-3] or \
            k.shape[-2:] != q.shape[-2:]:
        raise ValueError(f"{fn}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    hq, hkv = q.shape[-3], k.shape[-3]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{fn}: {hq} query rows are not a multiple of "
                         f"{hkv} KV rows")
    S, D = q.shape[-2:]
    if S % BLOCK:
        raise ValueError(f"{fn}: sequence length {S} is not a multiple "
                         f"of {BLOCK} (the reference kernel leaves the tail "
                         "rows unwritten there)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError(f"{fn}: q, k and v are on different devices")


def _check_head_dim(D: int, fn: str) -> None:
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {D} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")


def _strides(fn: str, named) -> list[int]:
    """The (batch, head, sequence) element strides of each 4-D ``(name,
    tensor)``, after checking the kernels' alignment rules."""
    out = []
    for name, x in named:
        if x.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} needs a unit stride along the "
                             "head dim")
        item = x.element_size()
        if x.data_ptr() % 16 or any(s * item % 16 for s in x.stride()[:3]):
            raise ValueError(f"{fn}: {name} must be 16-byte aligned with "
                             f"16-byte strides; strides {x.stride()}")
        out += list(x.stride()[:3])
    return out


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
    _check_head_dim(D, "flash_fwd")
    o = torch.empty_like(q)       # keeps q's strides (a dense view)
    q4, k4, v4, o4 = (x.unsqueeze(0) if x.dim() == 3 else x
                      for x in (q, k, v, o))
    B, Hq, S, _ = q4.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    strides = _strides("flash_fwd", (("q", q4), ("k", k4), ("v", v4),
                                     ("o", o4)))
    dims = (ctypes.c_longlong * 19)(B, Hq, k4.shape[1], S, D, *strides,
                                    int(window), int(bool(causal)))
    lib, _ = build()
    rc = lib.flash_fwd_launch(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                              o4.data_ptr(), lse.data_ptr(), dims,
                              1.0 / math.sqrt(D), _DTYPES[q.dtype],
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    _build.count_launch(flash_fwd)
    return o, (lse[0] if q.dim() == 3 else lse)


flash_fwd.launches = 0


def flash_bwd(q, k, v, o, lse, do, *, window: int = 0, causal: bool = True):
    """Gradients of :func:`flash_fwd` from its saved ``o`` and ``lse``.

    q, o, do: [BH, S, D] with k/v [BHkv, S, D], or [B, Hq, S, D] with k/v
    [B, Hkv, S, D] (strided views with a unit last stride, read in place,
    as :func:`flash_fwd` takes them); lse: [BH, S] or [B, Hq, S] float32.
    Returns (dq, dk, dv) shaped, strided and typed like q, k and v, with dk
    and dv summed over each GQA group.  On CUDA tensors ``delta =
    rowsum(do * o)`` is a float32 torch pre-pass, as the reference computes
    it outside its kernels; then one dq launch and one dk/dv launch.
    """
    _check(q, k, v, "flash_bwd")
    for name, x in (("o", o), ("do", do)):
        if not isinstance(x, torch.Tensor) or x.shape != q.shape or \
                x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_bwd: {name} must match q in shape, "
                             f"dtype and device")
    if not isinstance(lse, torch.Tensor) or lse.shape != q.shape[:-1] or \
            lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_bwd: lse must be float32 "
                         f"{tuple(q.shape[:-1])} on q's device")
    dev = q.device
    if dev.type == "cpu":
        flat = [x.flatten(0, 1) if q.dim() == 4 else x
                for x in (q, k, v, o, lse, do)]
        grads = attention_bwd_ref(*flat, window=window, causal=causal)
        return tuple(gr.to(x.dtype).reshape(x.shape)
                     for gr, x in zip(grads, (q, k, v)))
    if dev.type != "cuda":
        raise ValueError(f"flash_bwd runs on cpu or cuda tensors, not {dev}")
    call = BwdCall(q, k, v, o, lse, do, window=window, causal=causal)
    call.dq()
    call.dkv()
    return call.grads


def _row_stats(lse, o4, do4) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' per-row float32 inputs, [B, Hq, S] and contiguous: lse
    (copied where it does not start on a 16-byte boundary, since the dk/dv
    kernel copies its rows in 256-byte bulk loads) and ``delta =
    rowsum(do * o)``."""
    B, Hq, S, _ = o4.shape
    lse = lse.reshape(B, Hq, S).contiguous()
    if lse.data_ptr() % 16:
        lse = lse.clone()
    return lse, (do4.float() * o4.float()).sum(-1).contiguous()


class BwdCall:
    """One backward on the card, prepared once: the float32 ``delta =
    rowsum(do * o)`` pre-pass, the outputs (shaped, strided and typed like
    q, k and v) and the launch arguments.  :meth:`dq` and :meth:`dkv` launch
    the two kernels (each counted on :func:`flash_bwd`); ``grads`` holds
    (dq, dk, dv).  Takes what the CUDA branch of :func:`flash_bwd` takes,
    checked."""

    def __init__(self, q, k, v, o, lse, do, *, window: int, causal: bool):
        D = q.shape[-1]
        _check_head_dim(D, "flash_bwd")
        self.grads = tuple(torch.empty_like(x) for x in (q, k, v))
        q4, k4, v4, o4, do4, dq4, dk4, dv4 = (
            x.unsqueeze(0) if x.dim() == 3 else x
            for x in (q, k, v, o, do) + self.grads)
        B, Hq, S, _ = q4.shape
        self._lse, self._delta = _row_stats(lse, o4, do4)
        strides = _strides("flash_bwd", (("q", q4), ("k", k4), ("v", v4),
                                         ("do", do4), ("dq", dq4),
                                         ("dk", dk4), ("dv", dv4)))
        self._dims = (ctypes.c_longlong * 28)(
            B, Hq, k4.shape[1], S, D, *strides, int(window),
            int(bool(causal)))
        self._lib, _ = _build.build("flash_bwd")
        self._operands = (q4, k4, v4, do4)     # alive while launched
        self._head = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                      do4.data_ptr(), self._lse.data_ptr(),
                      self._delta.data_ptr())
        self._tail = (self._dims, 1.0 / math.sqrt(D), _DTYPES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream)
        self._out = (dq4.data_ptr(), dk4.data_ptr(), dv4.data_ptr())

    def dq(self) -> None:
        rc = self._lib.flash_bwd_dq_launch(*self._head, self._out[0],
                                           *self._tail)
        if rc != 0:
            raise RuntimeError(f"flash_bwd dq kernel launch failed: CUDA "
                               f"error {rc}")
        _build.count_launch(flash_bwd, "launches_dq")

    def dkv(self) -> None:
        rc = self._lib.flash_bwd_dkv_launch(*self._head, *self._out[1:],
                                            *self._tail)
        if rc != 0:
            raise RuntimeError(f"flash_bwd dk/dv kernel launch failed: "
                               f"CUDA error {rc}")
        _build.count_launch(flash_bwd, "launches_dkv")


flash_bwd.launches_dq = 0
flash_bwd.launches_dkv = 0
