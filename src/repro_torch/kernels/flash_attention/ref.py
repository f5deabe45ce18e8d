"""Plain torch versions of the flash attention forward and backward (fp32
softmax).

The port of ``repro/kernels/flash_attention/ref.py`` (forward) and of the
math of the reference's ``flash_bwd`` (``kernel.py:201-255``): the CUDA
kernels' plain versions, run for CPU tensors and held against the kernels
on the card.  They materialize the ``[BH, S, S]`` float32 scores, so on the
card they are usable only for short sequences.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "attention_ref", "attention_bwd_ref"]

NEG_INF = -1e30


def _visible(S: int, window: int, causal: bool, device) -> torch.Tensor:
    """[S, S] bool: key ``k`` is visible to query ``q``."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def attention_ref(q, k, v, *, window: int = 0, causal: bool = True):
    """q: [BH, S, D]; k/v: [BHkv, S, D] (GQA: BH = BHkv * group, query row
    ``b`` reads KV row ``b // group``).  Returns (o [BH, S, D] in q's dtype,
    lse [BH, S] float32)."""
    BH, S, D = q.shape
    group = BH // k.shape[0]
    kr = k.repeat_interleave(group, dim=0)
    vr = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) / math.sqrt(D)
    ok = _visible(S, window, causal, q.device)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    o = torch.einsum("bqk,bkd->bqd", p / l[..., None].clamp_min(1e-30),
                     vr.float())
    lse = m[..., 0] + torch.log(l.clamp_min(1e-30))
    return o.to(q.dtype), lse


def attention_bwd_ref(q, k, v, o, lse, do, *, window: int = 0,
                      causal: bool = True):
    """Gradients of :func:`attention_ref` from its saved ``o`` and ``lse``.

    q, o, do: [BH, S, D]; k/v: [BHkv, S, D]; lse: [BH, S] float32.  With
    ``delta = rowsum(do * o)`` in float32 and scale ``1/sqrt(D)``:
    ``p = exp(s * scale - lse)`` on visible pairs (0 elsewhere),
    ``ds = p * (dp - delta) * scale``, ``dq = ds k``, ``dk = ds^T q``,
    ``dv = p^T do``.  Returns float32 (dq [BH, S, D], dk and dv [BHkv, S,
    D] summed over each GQA group, as the reference's caller does).
    """
    BH, S, D = q.shape
    BHkv = k.shape[0]
    group = BH // BHkv
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(group, dim=0)
    vr = v.float().repeat_interleave(group, dim=0)
    delta = (dof * o.float()).sum(-1)
    s = torch.einsum("bqd,bkd->bqk", qf, kr) * scale
    ok = _visible(S, window, causal, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bqd,bkd->bqk", dof, vr)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kr)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return (dq, dk.reshape(BHkv, group, S, D).sum(1),
            dv.reshape(BHkv, group, S, D).sum(1))
