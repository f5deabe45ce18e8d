"""Shared building blocks: norms, MLPs, embeddings, RoPE, M-RoPE and
learned positions.

The port of ``repro/models/layers.py``.  Parameters come as dicts of
tensors (``nn.ParameterDict``s) with the reference's names and per-layer
shapes; activations keep the reference's layouts.  Under tensor
parallelism a rank holds a block of the vocabulary: :func:`apply_embed_tp`
looks up its own rows only (zeros elsewhere, summed over ``model`` by the
caller) and :func:`apply_unembed` gives its block of the logits' columns;
:func:`apply_mlp` on a rank's ``mlp`` block is its partial product.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from .params import ParamSpec

__all__ = ["norm_spec", "apply_norm", "mlp_spec", "apply_mlp", "embed_spec",
           "apply_embed", "apply_embed_tp", "apply_unembed", "rope_freqs", "apply_rope",
           "apply_mrope", "learned_pos_spec"]

# ---------------------------------------------------------------- norms


def norm_spec(cfg: ModelConfig, layers: int | None = None) -> dict:
    """One layer's norm; ``layers`` is the reference's stacked axis."""
    stack = layers or 1
    d = {"scale": ParamSpec((cfg.d_model,), ("norm",), init="ones",
                            dtype=torch.float32, stack=stack)}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), ("norm",), init="zeros",
                              dtype=torch.float32, stack=stack)
    return d


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- MLP


def mlp_spec(cfg: ModelConfig, d_ff: int, layers: int | None = None) -> dict:
    d, stack = cfg.d_model, layers or 1
    if cfg.activation == "swiglu":
        return {
            "wi": ParamSpec((d, 2, d_ff), ("embed", None, "mlp"),
                            stack=stack),
            "wo": ParamSpec((d_ff, d), ("mlp", "embed"), stack=stack),
        }
    return {
        "wi": ParamSpec((d, d_ff), ("embed", "mlp"), stack=stack),
        "wo": ParamSpec((d_ff, d), ("mlp", "embed"), stack=stack),
    }


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    wi = p["wi"]
    if cfg.activation == "swiglu":
        gu = (x @ wi.reshape(wi.shape[0], -1)).unflatten(-1, wi.shape[1:])
        g, u = gu[..., 0, :], gu[..., 1, :]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = x @ wi
        if cfg.activation == "relu2":        # squared ReLU (nemotron-4)
            h = torch.square(torch.relu(h))
        else:
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]


# ---------------------------------------------------------------- embeddings


def embed_spec(cfg: ModelConfig, padded_vocab: int) -> dict:
    d = {"embedding": ParamSpec((padded_vocab, cfg.d_model),
                                ("vocab", "embed"), init="normal", scale=1.0)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamSpec((cfg.d_model, padded_vocab),
                                 ("embed", "vocab"), init="fan_in")
    return d


def apply_embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def apply_embed_tp(p, tokens: torch.Tensor, rank: int) -> torch.Tensor:
    """A vocabulary-parallel rank's share of the lookup: the rows of its
    block ``[rank * V_local, (rank + 1) * V_local)`` of the embedding,
    zeros for tokens outside it."""
    table = p["embedding"]
    n = table.shape[0]
    ids = tokens - rank * n
    ok = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


def apply_unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].t()
    else:
        logits = x @ p["unembed"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL).  x: [..., seq, heads, head_dim];
    positions: [..., seq, 3], the (t, h, w) ids.  The head_dim / 2
    frequency bands are split into ``sections`` (t's, h's, w's), and each
    band turns by its own stream's position, in float32."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {sections} do not add up "
                         f"to half the head dim ({half})")
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)                       # [half]
    sec_id = torch.as_tensor(np.repeat(np.arange(len(sections)), sections),
                             device=x.device)                      # [half]
    band_pos = positions.float()[..., sec_id]          # [..., S, half]
    ang = band_pos * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- learned


def learned_pos_spec(cfg: ModelConfig, max_pos: int) -> dict:
    """A learned position table [max_pos, d_model] (whisper's)."""
    return {"pos_embedding": ParamSpec((max_pos, cfg.d_model),
                                       (None, "embed"), init="normal",
                                       scale=0.02)}
