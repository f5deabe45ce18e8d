"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3).

The port of ``repro/models/mla.py``.  Prefill materializes per-head K/V
from the compressed latent and pads V up to the qk head dim (64 -> 96 for
minicpm3), so the flash kernel sees one head dim; decode keeps only the
latent cache [B, S, kv_lora_rank] and the shared rope key [B, S, rope_dim]
(bf16, written in place) and uses the *absorbed* form:

    score(s) = (Wuk_h^T q_nope_h) . c_s + q_rope_h . k_rope_s
    out_h    = Wuv_h ( sum_s softmax(score)_s c_s )

in plain torch, as the reference computes it outside any Pallas kernel,
with its dtypes: ``q_eff`` in the activation dtype, the logits and the
softmax in float32.

Under tensor parallelism (the reference's GSPMD partitioning by its rules:
``q_lora`` over ``model``, so ``wq_a`` is split by columns and ``wq_b`` by
rows, every rank holding all of ``wq_b``'s heads; ``wk_b``, ``wv_b`` and
``wo`` over ``heads``; ``wkv_a``, ``kv_norm`` and ``q_norm`` whole) a
rank's prefill is three rank-local pieces between two collectives, run by
``models/lm.py``: :func:`mla_q_tp_a` (its block of the q latent and that
block's sum of squares, which the caller psums over ``model``: the q
RMSNorm's mean is over the whole ``q_lora_rank``), :func:`mla_q_tp_b` (the
block normalized with its block of ``q_norm`` and its partial product with
``wq_b``'s rows, which the caller reduce-scatters over ``model`` along the
heads), and :func:`mla_attn_tp` (the full latent and rope key from the
whole ``wkv_a``, its heads' K and V from its blocks of ``wk_b`` and
``wv_b``, attention on its heads, and its partial ``wo`` product, which
the caller sums over ``model``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..parallel.sharding import padded
from .attention import NEG_INF, _out, _proj, flash_or_ref
from .layers import apply_rope
from .params import ParamSpec

__all__ = ["mla_spec", "MLACache", "init_mla_cache", "mla_block",
           "mla_decode", "mla_q_tp_a", "mla_q_tp_b", "mla_attn_tp"]


def mla_spec(cfg: ModelConfig, tp: int, layers: int | None = None) -> dict:
    """One layer's MLA parameters; ``layers`` is the reference's stacked
    axis (the fan-in rule counts it)."""
    m, d, stack = cfg.mla, cfg.d_model, layers or 1
    nh = padded(cfg.num_heads, tp)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora"),
                          stack=stack),
        "q_norm": ParamSpec((m.q_lora_rank,), ("norm",), init="ones",
                            dtype=torch.float32, stack=stack),
        "wq_b": ParamSpec((m.q_lora_rank, nh, qk),
                          ("q_lora", "heads", "head_dim"), stack=stack),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "kv_lora"), stack=stack),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("norm",), init="ones",
                             dtype=torch.float32, stack=stack),
        "wk_b": ParamSpec((m.kv_lora_rank, nh, m.qk_nope_head_dim),
                          ("kv_lora", "heads", "head_dim"), stack=stack),
        "wv_b": ParamSpec((m.kv_lora_rank, nh, m.v_head_dim),
                          ("kv_lora", "heads", "head_dim"), stack=stack),
        "wo": ParamSpec((nh, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                        stack=stack),
    }


RMS_EPS = 1e-6


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = RMS_EPS
         ) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


def _q_parts(q: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope, q_rope turned by RoPE) of queries ``q`` [B, S, H, qk]."""
    m = cfg.mla
    return q[..., : m.qk_nope_head_dim], apply_rope(
        q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)


def _latent(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(latent c [B, S, rank], k_rope [B, S, 1, rope]) of ``x`` [B, S, d]
    from the whole ``wkv_a`` and ``kv_norm``."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c = _rms(kv[..., : m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return c, k_rope


def _project(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope], latent c [B, S,
    rank], k_rope [B, S, 1, rope]) of ``x`` [B, S, d]."""
    q = _proj(_rms(x @ p["wq_a"], p["q_norm"]), p["wq_b"])
    return (*_q_parts(q, cfg, positions), *_latent(p, x, cfg, positions))


class MLACache(NamedTuple):
    c: torch.Tensor         # [B, S, kv_lora_rank] latent, bf16
    k_rope: torch.Tensor    # [B, S, rope_dim], bf16


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, device
                   ) -> MLACache:
    m = cfg.mla
    return MLACache(
        torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=torch.bfloat16,
                    device=device),
        torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                    dtype=torch.bfloat16, device=device))


def mla_block(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
              use_flash: bool = False) -> torch.Tensor:
    """Prefill: per-head K/V materialized from the latent, V padded to the
    qk head dim for the attention and sliced back after it."""
    q_nope, q_rope, c, k_rope = _project(p, x, cfg, positions)
    return _attend(p, torch.cat([q_nope, q_rope], dim=-1), c, k_rope, cfg,
                   positions, use_flash)


def _attend(p, q: torch.Tensor, c: torch.Tensor, k_rope: torch.Tensor,
            cfg: ModelConfig, positions: torch.Tensor, use_flash: bool
            ) -> torch.Tensor:
    """Attention of ``q`` (its nope and turned rope parts) over the heads'
    K and V from the latent ``c`` and the shared ``k_rope``, V padded to
    the qk head dim and sliced back, then the ``wo`` product."""
    m = cfg.mla
    k_nope = _proj(c, p["wk_b"])
    v = _proj(c, p["wv_b"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], -1)], dim=-1)
    v = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
    o = flash_or_ref(q, k, v, positions, positions, window=0,
                     use_flash=use_flash)
    return _out(o[..., : m.v_head_dim], p["wo"])


def mla_q_tp_a(wq_a: torch.Tensor, h: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A tensor-parallel rank's block of the q latent ``h @ wq_a`` (``wq_a``
    its block of columns) and the block's float32 sum of squares [B, S,
    1], to be summed over ``model``."""
    ql = h @ wq_a
    return ql, ql.float().pow(2).sum(-1, keepdim=True)


def mla_q_tp_b(p, ql: torch.Tensor, sq: torch.Tensor, cfg: ModelConfig,
               rank: int) -> torch.Tensor:
    """The rank's block ``ql`` of the q latent normalized as ``_rms`` does
    the whole latent (``sq`` the whole latent's sum of squares, the mean
    over ``q_lora_rank``) with its block of ``q_norm``, then its partial
    product with its rows of ``wq_b`` [B, S, heads, qk], to be
    reduce-scattered over ``model`` along the heads."""
    n = ql.shape[-1]
    scale = p["q_norm"][rank * n:(rank + 1) * n]
    mean = sq / torch.full((), cfg.mla.q_lora_rank, dtype=sq.dtype,
                           device=sq.device)
    y = (ql.float() * torch.rsqrt(mean + RMS_EPS) * scale).to(ql.dtype)
    return _proj(y, p["wq_b"])


def mla_attn_tp(p, h: torch.Tensor, q: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, use_flash: bool = False
                ) -> torch.Tensor:
    """A tensor-parallel rank's attention on its heads: ``q`` [B, S,
    heads / tp, qk] its heads' queries (RoPE not yet applied), the full
    latent and rope key from ``h`` and the whole ``wkv_a`` and
    ``kv_norm``, its heads' K and V from its blocks of ``wk_b`` and
    ``wv_b``; returns its partial ``wo`` product [B, S, d], to be summed
    over ``model``."""
    q = torch.cat(_q_parts(q, cfg, positions), dim=-1)
    c, k_rope = _latent(p, h, cfg, positions)
    return _attend(p, q, c, k_rope, cfg, positions, use_flash)


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: MLACache,
               pos: torch.Tensor) -> tuple[torch.Tensor, MLACache]:
    """Absorbed one-token decode over the latent cache, written in place.
    x: [B, 1, d]; pos: [B].  Returns ([B, 1, d], cache)."""
    m = cfg.mla
    q_nope, q_rope, c_new, k_rope_new = _project(p, x, cfg, pos[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    cache.c[bidx, pos] = c_new[:, 0].to(cache.c.dtype)
    cache.k_rope[bidx, pos] = k_rope_new[:, 0, 0].to(cache.k_rope.dtype)
    # absorb: q_eff[h, r] = sum_k q_nope[h, k] wk_b[r, h, k]
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["wk_b"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    c_f = cache.c.float()
    logits = (torch.einsum("bhr,bsr->bhs", q_eff.float(), c_f)
              + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(),
                             cache.k_rope.float())) * scale
    valid = torch.arange(c_f.shape[1], device=x.device)[None] <= pos[:, None]
    logits = torch.where(valid[:, None], logits,
                         torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", w, c_f)
    o = torch.einsum("bhr,rhk->bhk", ctx.to(x.dtype), p["wv_b"])
    return _out(o, p["wo"])[:, None], cache
