"""Model-side entry of the flash attention forward.

The port of ``repro/kernels/flash_attention/ops.py``:
:func:`flash_attention` takes ``[B, S, H, D]`` activations.  On CUDA
tensors the kernel reads them through strides, in place (the reference
copies them into ``[B*H, S, D]`` first), and writes ``o`` straight into a
``[B, S, Hq, D]`` tensor; on CPU tensors the plain version runs on the
reference's ``[B*H, S, D]`` copies.

It is a ``torch.autograd.Function`` whose backward raises: the backward
kernels (``_dq_kernel``, ``_dkv_kernel``) come with the training slice, and
a forward that needs a gradient must not run the plain version under
autograd instead.
"""
from __future__ import annotations

import torch

from .kernel import flash_fwd

__all__ = ["flash_attention"]


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        if q.device.type == "cuda":
            o, _ = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), window=window, causal=causal)
            return o.transpose(1, 2)
        B, S, Hq, D = q.shape
        flat = [x.transpose(1, 2).reshape(-1, S, D) for x in (q, k, v)]
        o, _ = flash_fwd(*flat, window=window, causal=causal)
        return o.reshape(B, Hq, S, D).transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError("flash backward: ROADMAP queue 2 item 2")


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, window: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, S, Hq, D]; k/v: [B, S, Hkv, D] -> [B, S, Hq, D].

    Assumes contiguous positions (q_pos/k_pos accepted for API parity with
    the reference; the kernel derives positions from block indices).
    """
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    return _Flash.apply(q, k, v, int(window), bool(causal))
