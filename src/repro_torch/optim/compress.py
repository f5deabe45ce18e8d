"""Error-feedback gradient compression for the inter-pod (DCN) hop.

The port of ``repro/optim/compress.py``.  int8 block quantization with a
persistent residual: the quantization error is re-added to the next step's
gradient, so compression bias vanishes in expectation (standard EF-SGD
argument).  Cuts the pod<->pod wire bytes 4x, the hop whose contention
Symphony manages.  Divisions go by tensors, never by a Python scalar
(torch's CUDA kernel multiplies by the scalar's reciprocal instead).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["BLOCK", "Int8Meta", "encode_int8", "decode_int8",
           "ef_compress_update"]

BLOCK = 1024


class Int8Meta(NamedTuple):
    scale: torch.Tensor     # [nblocks] fp32 per-block scale


def encode_int8(x: torch.Tensor) -> tuple[torch.Tensor, Int8Meta]:
    """x: [n] fp32 -> (int8-in-fp32 container, meta).  The values stay in a
    float container because the ring all-reduce sums them (sum of int8 fits
    fp32 exactly up to 2^16 pods)."""
    n = x.shape[0]
    xp = F.pad(x, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    c127 = torch.full((), 127.0, dtype=x.dtype, device=x.device)
    scale = xp.abs().amax(dim=1) / c127 + 1e-12
    q = torch.clamp(torch.round(xp / scale[:, None]), -127, 127)
    return q.reshape(-1), Int8Meta(scale=scale)


def decode_int8(q: torch.Tensor, meta: Int8Meta) -> torch.Tensor:
    return (q.reshape(-1, BLOCK) * meta.scale[:, None]).reshape(-1)


def ef_compress_update(grad_flat: torch.Tensor, residual: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, Int8Meta]:
    """Apply error feedback: g' = g + residual; quantize; new residual =
    g' - dequant(quant(g'))."""
    g = grad_flat + residual
    q, meta = encode_int8(g)
    return q, g - decode_int8(q, meta), meta
