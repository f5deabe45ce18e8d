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
           "mla_decode"]


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


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


def _project(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope], latent c [B, S,
    rank], k_rope [B, S, 1, rope]) of ``x`` [B, S, d]."""
    m = cfg.mla
    ql = _rms(x @ p["wq_a"], p["q_norm"])
    q = _proj(ql, p["wq_b"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    kv = x @ p["wkv_a"]
    c = _rms(kv[..., : m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c, k_rope


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
    m = cfg.mla
    q_nope, q_rope, c, k_rope = _project(p, x, cfg, positions)
    k_nope = _proj(c, p["wk_b"])
    v = _proj(c, p["wv_b"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
    o = flash_or_ref(q, k, v, positions, positions, window=0,
                     use_flash=use_flash)
    return _out(o[..., : m.v_head_dim], p["wo"])


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
