"""The Mamba-2 SSD chunked scan as a hand-written CUDA kernel: binding,
wrapper.

``csrc/ssd.cu`` replaces the reference's Pallas ``_ssd_kernel``
(``src/repro/kernels/ssd/kernel.py:24``).  It is registered with
:mod:`repro_torch.kernels._build` like the other libraries, compiled at
first use (or by ``build_all()``) for ``sm_90a`` with the shared flags,
loaded with ``ctypes`` and launched on PyTorch's current stream.

What bounds it on the H100: operations (~10.5 MFLOP per row, head and
128-step chunk at N 128, P 64, ~170 flops a byte read; float32 on the CUDA
cores).  One block per (batch row, head) walks the chunks in order with the
chunk's x, B, C and the entering state in shared memory, the [Q, Q] scores
a stripe of rows at a time, and sums in a fixed order (see the source).

:func:`ssd_chunked` is the entry point: on CPU tensors it runs the plain
torch version (:func:`.ref.ssd_chunked_ref`); on CUDA tensors it launches
the kernel or raises.  ``ssd_chunked.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_chunked", "build", "MAX_CHUNK", "MAX_STATE", "MAX_HEAD_DIM"]

CSRC = Path(__file__).resolve().parent / "csrc"
# the kernel's on-chip tile: larger shapes are refused, smaller ones padded
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 128, 128, 64
_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.ssd_launch.argtypes = [p] * 7 + [ctypes.c_int, p]
    lib.ssd_launch.restype = ctypes.c_int


_build.register("ssd", CSRC, _bind)


def build() -> tuple[ctypes.CDLL, str]:
    """The loaded library, compiled first if need be."""
    return _build.build("ssd")


def _check(x, a, Bm, Cm, chunk: int, n_heads: int) -> None:
    fn = "ssd_chunked"
    if not all(isinstance(t, torch.Tensor) for t in (x, a, Bm, Cm)):
        raise TypeError(f"{fn}: x, a, Bm and Cm must be tensors")
    if x.dim() != 4 or a.shape != x.shape[:-1]:
        raise ValueError(f"{fn}: x must be [B, H, S, P] with a [B, H, S]; "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}")
    if Bm.dim() != 3 or Cm.shape != Bm.shape:
        raise ValueError(f"{fn}: Bm and Cm must both be [B, S, N]; got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, heads, S = x.shape[:3]
    if heads != n_heads or Bm.shape[:2] != (B, S):
        raise ValueError(f"{fn}: x {tuple(x.shape)} with n_heads={n_heads} "
                         f"does not match Bm {tuple(Bm.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"{fn}: sequence length {S} is not a multiple of "
                         f"the chunk {chunk} (ops.ssd pads it)")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"{fn}: x and a must be float32; got {x.dtype}, "
                        f"{a.dtype}")
    if Bm.dtype not in _BC_DTYPES or Cm.dtype != Bm.dtype:
        raise TypeError(f"{fn}: Bm and Cm must share one dtype of "
                        f"{list(_BC_DTYPES)}; got {Bm.dtype}, {Cm.dtype}")
    if len({t.device for t in (x, a, Bm, Cm)}) != 1:
        raise ValueError(f"{fn}: x, a, Bm and Cm are on different devices")


def ssd_chunked(x, a, Bm, Cm, *, chunk: int, n_heads: int):
    """The chunked SSD scan.

    x: [B, H, S, P] float32 with a: [B, H, S] float32 (any strided views
    with a unit last stride, such as ``x.transpose(1, 2)`` of
    ``[B, S, H, P]`` activations, which the kernel reads in place);
    Bm/Cm: [B, S, N], float32 or bf16, shared by the ``n_heads`` heads of a
    batch row.  ``S`` must be a multiple of ``chunk``.  Returns (y float32,
    shaped and strided like x; final state float32 [B, H, N, P]).
    """
    _check(x, a, Bm, Cm, chunk, n_heads)
    dev = x.device
    if dev.type == "cpu":
        y, fs = ssd_chunked_ref(x.flatten(0, 1), a.flatten(0, 1), Bm, Cm,
                                chunk=chunk, n_heads=n_heads)
        return y.unflatten(0, x.shape[:2]), fs.unflatten(0, x.shape[:2])
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunked runs on cpu or cuda tensors, not {dev}")
    B, S, N = Bm.shape
    P = x.shape[-1]
    if chunk > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunked: the kernel takes chunk <= "
                         f"{MAX_CHUNK}, N <= {MAX_STATE} and P <= "
                         f"{MAX_HEAD_DIM}; got {chunk}, {N}, {P}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunked: {name} needs a unit stride along "
                             f"its last dim; strides {t.stride()}")
    y = torch.empty_like(x)        # keeps x's strides (a dense view)
    fs = torch.empty((B, n_heads, N, P), dtype=torch.float32, device=dev)
    dims = (ctypes.c_longlong * 19)(
        B, n_heads, S, P, N, chunk, *x.stride()[:3], *a.stride()[:3],
        *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3])
    lib, _ = build()
    rc = lib.ssd_launch(x.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                        Cm.data_ptr(), y.data_ptr(), fs.data_ptr(), dims,
                        _BC_DTYPES[Bm.dtype],
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    ssd_chunked.launches += 1
    return y, fs


ssd_chunked.launches = 0
