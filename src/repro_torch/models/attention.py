"""Attention: GQA (+ sliding window), full prefill path and cached decode
path, RoPE or M-RoPE, and unmasked cross attention.

The port of ``repro/models/attention.py``.  The prefill softmax attention
dispatches to the flash kernel when enabled, else to the plain torch
version (query-chunked above ``CHUNK_ABOVE`` rows, unless
``flags.ROOFLINE_MODE`` asks for the unchunked one); cross attention
(``cross=True``: no mask, positions may be ``None``) never goes to the
kernel, as in the reference.  Shapes:
activations are [batch, seq, d_model]; q/k/v are [batch, seq, heads,
head_dim].  Decode KV caches are [batch, kv_heads, max_seq, head_dim] and
are written in place.  Decode attention stays plain torch, as the
reference computes it outside any Pallas kernel.

Under tensor parallelism a rank holds its block of the q heads (``wq``,
``wo``) and every KV head (``kv_heads`` is replicated, as the rule says);
:func:`attention_block_tp` slices ``wk``/``wv`` to the KV heads of the
rank's q heads (:func:`tp_kv_heads`: head ``j`` uses KV head ``j // g``)
and returns the rank's partial ``wo`` product, which the caller sums over
``model``.

M-RoPE prefill takes [B, S, 3] (t, h, w) positions and masks by the t
column, as the reference does; anything else raises ``ValueError``, where
the reference takes ``positions[..., 0]`` of [B, S] positions as a [B]
vector and its mask stops being causal.  Decode's [B, 1] positions stand
for t = h = w.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import flags
from ..config import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..parallel.sharding import padded
from .layers import apply_mrope, apply_rope
from .params import ParamSpec

__all__ = ["NEG_INF", "attn_spec", "effective_kv_heads", "ref_attention",
           "ref_attention_chunked", "flash_or_ref", "KVCache", "project_qkv",
           "mask_positions", "attention_block", "tp_kv_heads",
           "attention_block_tp", "decode_attention", "cached_attention"]

NEG_INF = -1e30
CHUNK = 512             # query rows per step of the chunked plain version
CHUNK_ABOVE = 2048      # sequences longer than this take the chunked one


def attn_spec(cfg: ModelConfig, tp: int, layers: int | None = None) -> dict:
    d, hd, stack = cfg.d_model, cfg.resolved_head_dim, layers or 1
    nh = padded(cfg.num_heads, tp)
    # MHA: pad kv heads with q heads; GQA: kv heads stay
    nkv = nh if cfg.num_kv_heads == cfg.num_heads else cfg.num_kv_heads
    return {
        "wq": ParamSpec((d, nh, hd), ("embed", "heads", "head_dim"),
                        stack=stack),
        "wk": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim"),
                        stack=stack),
        "wv": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim"),
                        stack=stack),
        "wo": ParamSpec((nh, hd, d), ("heads", "head_dim", "embed"),
                        stack=stack),
    }


def effective_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """KV head count after TP padding (matches attn_spec)."""
    nh = padded(cfg.num_heads, tp)
    return nh if cfg.num_kv_heads == cfg.num_heads else cfg.num_kv_heads


def _mask_bias(q_pos, k_pos, window: int) -> torch.Tensor:
    """[.., Sq, Sk] additive mask: causal (+ sliding window if window>0)."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, zero + NEG_INF)


def ref_attention(q, k, v, q_pos, k_pos, window: int = 0,
                  cross: bool = False) -> torch.Tensor:
    """Reference softmax attention with GQA head-group mapping.

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D].  fp32 softmax.  ``cross``:
    no mask (the positions are not read).
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    if not cross:
        logits = logits + _mask_bias(q_pos, k_pos, window)[:, None, None]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def ref_attention_chunked(q, k, v, q_pos, k_pos, window: int = 0,
                          cross: bool = False, chunk: int = CHUNK
                          ) -> torch.Tensor:
    """Streaming reference: one block of ``chunk`` query rows at a time, so
    the logits transient is [B, Hq, chunk, Sk] instead of [B, Hq, Sq, Sk].
    Same FLOPs, bounded memory."""
    B, Sq, Hq, D = q.shape
    if Sq % chunk:
        raise ValueError(f"sequence {Sq} is not a multiple of chunk {chunk}")
    out = torch.empty_like(q)
    for i in range(0, Sq, chunk):
        qp = None if q_pos is None else q_pos[..., i:i + chunk]
        out[:, i:i + chunk] = ref_attention(q[:, i:i + chunk], k, v, qp,
                                            k_pos, window=window,
                                            cross=cross)
    return out


def flash_or_ref(q, k, v, q_pos, k_pos, window: int = 0, cross: bool = False,
                 use_flash: bool = False) -> torch.Tensor:
    if use_flash and not cross:
        return flash_attention(q, k, v, q_pos, k_pos, window=window)
    if q.shape[1] > CHUNK_ABOVE and not flags.ROOFLINE_MODE:
        return ref_attention_chunked(q, k, v, q_pos, k_pos, window=window,
                                     cross=cross)
    return ref_attention(q, k, v, q_pos, k_pos, window=window, cross=cross)


class KVCache(NamedTuple):
    k: torch.Tensor     # [B, Hkv, S, D]
    v: torch.Tensor     # [B, Hkv, S, D]


def _proj(x, w) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions,
                rope: bool = True):
    """q, k, v [B, S, heads, head_dim] of ``x``, turned by the config's
    positions unless ``rope`` is False (whisper's learned positions and
    cross attention).  M-RoPE takes [B, S, 3] (t, h, w) positions; [B, S]
    ones (decode's [B, 1]) stand for t = h = w."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif rope and cfg.pos_emb == "mrope":
        if positions.dim() == 2:              # text only: t = h = w
            positions = positions[..., None].expand(*positions.shape, 3)
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def mask_positions(cfg: ModelConfig, positions: torch.Tensor
                   ) -> torch.Tensor:
    """The [B, S] positions a prefill masks by: M-RoPE's t column (raises
    ``ValueError`` unless ``positions`` is [B, S, 3]), else ``positions``."""
    if cfg.pos_emb != "mrope":
        return positions
    if positions.dim() != 3 or positions.shape[-1] != 3:
        raise ValueError(
            f"{cfg.name}: an M-RoPE prefill takes [B, S, 3] (t, h, w) "
            f"positions, not {tuple(positions.shape)} (the reference masks "
            "by positions[..., 0], which is then not causal)")
    return positions[..., 0]


def _out(o, wo) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, wo) as one matrix product, in the
    promoted dtype (a bf16 cache read meets float32 weights in decode)."""
    dt = torch.promote_types(o.dtype, wo.dtype)
    return o.flatten(-2).to(dt) @ wo.reshape(-1, wo.shape[-1]).to(dt)


def attention_block(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, use_flash: bool = False
                    ) -> torch.Tensor:
    """Full (prefill) self-attention."""
    pos1d = mask_positions(cfg, positions)
    q, k, v = project_qkv(p, x, cfg, positions)
    o = flash_or_ref(q, k, v, pos1d, pos1d, window=cfg.sliding_window,
                     use_flash=use_flash)
    return _out(o, p["wo"])


def tp_kv_heads(n_local: int, n_heads: int, n_kv: int, rank: int
                ) -> tuple[int, int]:
    """(first KV head, KV heads) that the q heads ``[rank * n_local,
    (rank + 1) * n_local)`` of ``n_heads`` use, head ``j`` using KV head
    ``j // g`` (``g = n_heads // n_kv``): ``n_local / g`` of them when
    ``g`` divides ``n_local``, one when ``n_local`` divides ``g``;
    ``ValueError`` otherwise (a rank's heads would straddle KV groups
    unevenly)."""
    g = n_heads // n_kv
    if n_local % g == 0:
        return rank * n_local // g, n_local // g
    if g % n_local == 0:
        return rank * n_local // g, 1
    raise ValueError(f"{n_local} q heads a rank of {n_heads} in groups of "
                     f"{g}: neither divides the other")


def attention_block_tp(p, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor, use_flash: bool, rank: int,
                       tp: int) -> torch.Tensor:
    """One tensor-parallel rank's full self-attention: its q heads, the KV
    heads they use, and its partial ``wo`` product [B, S, d] (to be summed
    over the ``tp`` ranks of ``model``)."""
    n_local, n_kv = p["wq"].shape[1], p["wk"].shape[1]
    kv0, nk = tp_kv_heads(n_local, n_local * tp, n_kv, rank)
    local = {"wq": p["wq"], "wk": p["wk"][:, kv0:kv0 + nk],
             "wv": p["wv"][:, kv0:kv0 + nk], "wo": p["wo"]}
    return attention_block(local, x, cfg, positions, use_flash)


def decode_attention(p, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                     pos: torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against a KV cache, written in place.

    x: [B, 1, d]; pos: [B] current position.  Sliding windows write a ring
    buffer at ``pos % window``.
    """
    B = x.shape[0]
    q, k_new, v_new = project_qkv(p, x, cfg, pos[:, None])
    wpos = (pos % cfg.sliding_window) if cfg.sliding_window else pos
    bidx = torch.arange(B, device=x.device)
    # cache layout [B, Hkv, S, D]; k_new[:, 0] is [B, Hkv, D]
    cache.k[bidx, :, wpos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[bidx, :, wpos] = v_new[:, 0].to(cache.v.dtype)
    o = cached_attention(q, cache, pos, window=cfg.sliding_window)
    return _out(o, p["wo"]), cache


def cached_attention(q: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """q: [B, 1, Hq, D]; cache k/v: [B, Hkv, S, D]; pos: [B].

    Computes softmax(q k^T) v with masking of unwritten / out-of-window slots,
    in the numerically safe two-pass (max, exp-sum) form.
    """
    B, _, Hq, D = q.shape
    Hkv, S = cache.k.shape[1], cache.k.shape[2]
    g = Hq // Hkv
    qg = q[:, 0].reshape(B, Hkv, g, D).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg,
                          cache.k.float()) / math.sqrt(D)
    slot = torch.arange(S, device=q.device)
    if window:
        # ring buffer of length `window`: once pos >= window every slot holds
        # an in-window position; before that only slots <= pos are written.
        valid = (slot[None] <= pos[:, None]) | (pos[:, None] >= window)
    else:
        valid = slot[None] <= pos[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    num = torch.einsum("bhgs,bhsd->bhgd", e, cache.v.float())
    den = e.sum(-1, keepdim=True)
    out = num / den.clamp_min(1e-30)
    return out.reshape(B, 1, Hq, D).to(cache.v.dtype)
