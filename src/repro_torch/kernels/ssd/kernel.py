"""The Mamba-2 SSD chunked scan as hand-written CUDA kernels: binding,
wrapper.

``csrc/ssd.cu`` replaces the reference's Pallas ``_ssd_kernel``
(``src/repro/kernels/ssd/kernel.py:24``).  It is registered with
:mod:`repro_torch.kernels._build` like the other libraries, compiled at
first use (or by ``build_all()``) for ``sm_90a`` with the shared flags,
loaded with ``ctypes`` and launched on PyTorch's current stream.

What bounds it on the H100: operations, on the tensor cores.  Per batch row
and 128-step chunk C Bᵀ over the causal triangle, per head (G ∘ L) x over
the triangle, C state and the chunk's state Bᵀ (d ∘ x): ~170 flops a byte
read.  TF32 keeps float32's range but 11 bits of mantissa, so every
float32 operand is split in two TF32 halves and each product taken as
three (two where one side is bf16, exact in TF32): ~1.2 ms at mamba2's
prefill shape against the 1.0 ms its inputs and outputs take to move.
One call launches four kernels in order (see the source): the in-chunk
prefix sums; every (row, chunk)'s chunk states, chunks in parallel; the
state pass, in chunk order over a [B, H, S / chunk, N, P] float32
workspace of chunk states (1.6 GB at 8 x 32,768 x 24 heads); the outputs,
chunks in parallel, with C Bᵀ once per row and chunk for all heads.  The
library also exports ``ssd_abi()`` (:data:`ABI`) and each kernel's dynamic
shared memory, ``ssd_smem_bytes(kernel, bc_dtype)``.

:func:`ssd_chunked` is the entry point: on CPU tensors it runs the plain
torch version (:func:`.ref.ssd_chunked_ref`); on CUDA tensors it launches
the kernels or raises.  ``ssd_chunked.launches`` counts calls that
launched them (one a call, however many kernels it runs).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_chunked", "build", "MAX_CHUNK", "MAX_STATE", "MAX_HEAD_DIM",
           "THREADS", "MMA_TILE", "WGMMA_TILE", "AUX_ROWS", "KERNELS", "ABI"]

CSRC = Path(__file__).resolve().parent / "csrc"
# the kernels' on-chip tile (QM, NM, PM in the source): larger shapes are
# refused, smaller ones padded
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 128, 128, 64
THREADS = 256                   # NT: every kernel's block
MMA_TILE = (16, 8, 8)           # mma.sync m16n8k8, TF32: C B^T
WGMMA_TILE = (64, 64, 8)        # wgmma m64n64k8, TF32: the per-head products
AUX_ROWS = 3                    # AUX: log2(e) cum, exp(cum), decay to end
# the kernels one call launches, in order
KERNELS = ("ssd_prep", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
ABI = 2                         # ssd_abi(): the ssd_launch that _bind declares
_BC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [p] * 10 + [i, p]
    lib.ssd_launch.restype = i
    lib.ssd_abi.argtypes = []
    lib.ssd_abi.restype = i
    lib.ssd_smem_bytes.argtypes = [i, i]
    lib.ssd_smem_bytes.restype = i


def _check_rows(x, Bm, Cm) -> None:
    """What the kernels' 16-byte loads need: x, Bm and Cm with a unit
    stride along their last dim, every row starting on a 16-byte boundary,
    and a head dim that is a multiple of 4."""
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunked: {name} needs a unit stride along "
                             f"its last dim; strides {t.stride()}")
        es = t.element_size()
        if t.data_ptr() % 16 or any(s * es % 16 for s in t.stride()[:-1]):
            raise ValueError(f"ssd_chunked: the kernels read {name} in "
                             f"16-byte pieces: its rows must start on "
                             f"16-byte boundaries (strides {t.stride()})")
    if x.shape[-1] % 4:
        raise ValueError(f"ssd_chunked: the kernels take a head dim that is "
                         f"a multiple of 4; got {x.shape[-1]}")


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
    _check_rows(x, Bm, Cm)
    y = torch.empty_like(x)        # keeps x's strides (a dense view)
    fs = torch.empty((B, n_heads, N, P), dtype=torch.float32, device=dev)
    nc = S // chunk
    ws = torch.empty((B, n_heads, nc, N, P), dtype=torch.float32, device=dev)
    aux = torch.empty((B, n_heads, nc, AUX_ROWS, MAX_CHUNK),
                      dtype=torch.float32, device=dev)
    dec = torch.empty((B, n_heads, nc), dtype=torch.float32, device=dev)
    dims = (ctypes.c_longlong * 19)(
        B, n_heads, S, P, N, chunk, *x.stride()[:3], *a.stride()[:3],
        *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3])
    lib, _ = build()
    rc = lib.ssd_launch(x.data_ptr(), a.data_ptr(), Bm.data_ptr(),
                        Cm.data_ptr(), y.data_ptr(), fs.data_ptr(),
                        ws.data_ptr(), aux.data_ptr(), dec.data_ptr(), dims,
                        _BC_DTYPES[Bm.dtype],
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    ssd_chunked.launches += 1
    return y, fs


ssd_chunked.launches = 0
