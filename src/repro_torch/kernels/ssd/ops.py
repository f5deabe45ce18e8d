"""Model-side entry of the SSD scan.

The port of ``repro/kernels/ssd/ops.py``: :func:`ssd` takes the model's
``[B, S, H, P]`` layout, pads S to a multiple of the chunk (zero steps
change neither y nor the final state) and returns the final state as
``[B, H, P, N]``.  On CUDA tensors the kernel reads x and a through
strides and writes y into a ``[B, S, H, P]`` tensor (the reference copies
them to ``[B*H, S, P]`` and back); on CPU tensors the plain version runs on
``[B*H, S, P]`` copies, as the reference's kernel does.

The kernel is forward only, as the reference's is (its ``ops.py`` defines
no ``custom_vjp``); a ctypes launch is invisible to autograd, so :func:`ssd`
raises rather than drop a gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_chunked

__all__ = ["ssd"]


def ssd(x, a, Bm, Cm, *, chunk: int = 128):
    """x: [B, S, H, P] dt-scaled inputs (float32); a: [B, S, H] log decay
    (float32); Bm/Cm: [B, S, N] (float32 or bf16).  Returns (y [B, S, H, P]
    float32, final state [B, H, P, N] float32)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, Bm, Cm)):
        raise NotImplementedError(
            "ssd: the SSD kernel is forward only, as the reference's is; "
            "training through it waits for an SSD backward (ROADMAP queue 1 "
            "item 8).  Build the model with use_ssd_kernel=False to train "
            "on the plain path.")
    B, S, H, P = x.shape
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, fs = ssd_chunked(x.transpose(1, 2), a.transpose(1, 2), Bm, Cm,
                        chunk=chunk, n_heads=H)
    return y.transpose(1, 2)[:, :S], fs.transpose(-1, -2)
