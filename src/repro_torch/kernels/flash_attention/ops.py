"""Model-side entry of the flash attention, forward and backward.

The port of ``repro/kernels/flash_attention/ops.py``:
:func:`flash_attention` takes ``[B, S, H, D]`` activations.  On CUDA
tensors the kernels read them through strides, in place (the reference
copies them into ``[B*H, S, D]`` first), and write ``o`` (forward) and
``dq``/``dk``/``dv`` (backward) straight into ``[B, S, H, D]`` tensors; on
CPU tensors the plain versions run on ``[B*H, S, D]`` copies, as the
reference's kernels do.

It is a ``torch.autograd.Function`` (the reference's ``custom_vjp``): the
forward saves q, k, v, o and lse, and the backward runs :func:`flash_bwd`
(the dq and dk/dv kernels) and returns the gradients in the inputs'
dtypes, as ``_flash_bwd_rule`` does.
"""
from __future__ import annotations

import torch

from .kernel import flash_bwd, flash_fwd

__all__ = ["flash_attention"]


class _Flash(torch.autograd.Function):
    """Both directions take ``[B, H, S, D]`` views of the ``[B, S, H, D]``
    tensors: the kernels read and write them in place, the plain versions
    flatten them to ``[B*H, S, D]`` copies."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        ctx.window, ctx.causal = window, causal
        o, lse = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), window=window, causal=causal)
        o = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # do may arrive expanded or strided
        dq, dk, dv = flash_bwd(*(x.transpose(1, 2) for x in (q, k, v, o)),
                               lse, do.contiguous().transpose(1, 2),
                               window=ctx.window, causal=ctx.causal)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


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
