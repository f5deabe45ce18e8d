"""Plain torch version of the flash attention forward (fp32 softmax).

The port of ``repro/kernels/flash_attention/ref.py``: the CUDA kernel's
plain version, run for CPU tensors and held against the kernel on the card.
It materializes the ``[BH, S, S]`` float32 scores, so on the card it is
usable only for short sequences.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "attention_ref"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, window: int = 0, causal: bool = True):
    """q: [BH, S, D]; k/v: [BHkv, S, D] (GQA: BH = BHkv * group, query row
    ``b`` reads KV row ``b // group``).  Returns (o [BH, S, D] in q's dtype,
    lse [BH, S] float32)."""
    BH, S, D = q.shape
    group = BH // k.shape[0]
    kr = k.repeat_interleave(group, dim=0)
    vr = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    o = torch.einsum("bqk,bkd->bqd", p / l[..., None].clamp_min(1e-30),
                     vr.float())
    lse = m[..., 0] + torch.log(l.clamp_min(1e-30))
    return o.to(q.dtype), lse
