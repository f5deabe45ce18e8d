"""Decoder-only LM assembly for the dense GQA and the Mamba-2 SSM
families.

The port of ``repro/models/lm.py`` for ``family == "dense"``,
``attention == "gqa"``, and ``family == "ssm"`` (period 1 both).  The
reference stacks every layer's parameters on a leading ``[n_groups]`` axis
and scans over it; the port keeps one :class:`Block` per layer in an
``nn.ModuleList`` and loops (``models/convert.py`` maps the reference's
stacked tree onto it).  A block holds ``ln1`` and its mixer (``attn`` or
``ssm``, by ``cfg.layer_kind``), and ``ln2``/``mlp`` when ``d_ff`` is set.
The model owns its parameters: ``apply``, ``init_cache`` and
``decode_step`` take no parameter tree.  With ``par.remat`` other than
``"none"`` each block runs under ``torch.utils.checkpoint`` when gradients
are taken: the reference's per-group ``jax.checkpoint``, a group being one
layer here.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, ParallelConfig
from ..parallel.sharding import padded
from . import params as prm
from .attention import (KVCache, attention_block, attn_spec, decode_attention,
                        effective_kv_heads)
from .layers import (apply_embed, apply_mlp, apply_norm, apply_unembed,
                     embed_spec, mlp_spec, norm_spec)
from .ssm import SSMCache, init_ssm_cache, ssm_block, ssm_decode, ssm_spec

__all__ = ["LM", "Block"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Block(nn.Module):
    """One layer: norm, mixer (attention or SSM), and norm and MLP when the
    model has one, each a dict of parameters under the reference's names."""

    def __init__(self, spec: dict, device):
        super().__init__()
        for name, sub in spec.items():
            self.add_module(name, prm.module_from_spec(sub, device))


class LM(nn.Module):
    """Decoder: embedding, ``num_layers`` blocks, final norm, (tied)
    unembedding.  Built without values; :meth:`init` draws them.
    ``use_flash`` sends full-sequence attention through the flash kernels,
    ``use_ssd_kernel`` the SSM mixer's scan through the SSD kernel."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig | None = None,
                 use_flash: bool = False, use_ssd_kernel: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.par = par or ParallelConfig()
        self.use_flash = use_flash
        self.use_ssd_kernel = use_ssd_kernel
        self.tp = 1                     # no mesh: one card
        self.vocab_padded = padded(cfg.vocab_size, self.tp * 128)
        spec = self.param_spec()
        self.embed = prm.module_from_spec(spec["embed"], device)
        self.blocks = nn.ModuleList(
            Block(spec["blocks"][str(i)], device)
            for i in range(cfg.num_layers))
        self.final_norm = prm.module_from_spec(spec["final_norm"], device)

    # ------------------------------------------------------------ specs
    def _block_spec(self, i: int) -> dict:
        cfg, n = self.cfg, self.cfg.num_layers
        d: dict = {"ln1": norm_spec(cfg, n)}
        if cfg.layer_kind(i) == "attn":
            d["attn"] = attn_spec(cfg, self.tp, n)
        else:
            d["ssm"] = ssm_spec(cfg, self.tp, n)
        if cfg.d_ff:
            d["ln2"] = norm_spec(cfg, n)
            d["mlp"] = mlp_spec(cfg, cfg.d_ff, n)
        return d

    def param_spec(self) -> dict:
        """The parameter tree, one entry per layer under ``blocks``."""
        cfg = self.cfg
        return {"embed": embed_spec(cfg, self.vocab_padded),
                "blocks": {str(i): self._block_spec(i)
                           for i in range(cfg.num_layers)},
                "final_norm": norm_spec(cfg)}

    def init(self, generator: torch.Generator) -> "LM":
        """Draw every parameter by the reference's rules from ``generator``
        (on the parameters' device)."""
        prm.init_tree(self, self.param_spec(), generator)
        return self

    # ------------------------------------------------------------ forward
    def _apply_block(self, bp: Block, i: int, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(bp.ln1, x, cfg)
        if cfg.layer_kind(i) == "attn":
            h = attention_block(bp.attn, h, cfg, positions, self.use_flash)
        else:
            h = ssm_block(bp.ssm, h, cfg, self.use_ssd_kernel)
        x = x + h
        if cfg.d_ff:
            x = x + apply_mlp(bp.mlp, apply_norm(bp.ln2, x, cfg), cfg)
        return x

    def apply(self, tokens: torch.Tensor | None = None,
              positions: torch.Tensor | None = None,
              embeds: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefill forward.

        tokens: [B, S] integer (or ``embeds`` [B, S, d]).  positions: [B, S].
        Returns (logits [B, S, padded vocab], aux = 0).
        """
        cfg = self.cfg
        dt = _dtype(cfg.dtype)
        x = (apply_embed(self.embed, tokens) if embeds is None
             else embeds).to(dt)
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        remat = self.par.remat != "none" and torch.is_grad_enabled()
        for i, bp in enumerate(self.blocks):
            if remat:
                x = checkpoint(self._apply_block, bp, i, x, positions,
                               use_reentrant=False)
            else:
                x = self._apply_block(bp, i, x, positions)
        x = apply_norm(self.final_norm, x, cfg)
        logits = apply_unembed(self.embed, x, cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------ decode
    def kv_cache_len(self, max_seq: int) -> int:
        """Positions a layer's KV cache holds: ``min(max_seq, window)`` for
        sliding windows, else ``max_seq``."""
        w = self.cfg.sliding_window
        return min(max_seq, w) if w else max_seq

    def init_cache(self, batch: int, max_seq: int
                   ) -> list[KVCache | SSMCache]:
        """One cache per layer: a bf16 KV cache ``[batch, kv_heads, S,
        head_dim]`` (``S`` = :meth:`kv_cache_len`) for attention, a conv
        window and float32 state (:func:`~.ssm.init_ssm_cache`) for SSM
        layers."""
        cfg = self.cfg
        dev = self.final_norm["scale"].device
        caches: list = []
        for i in range(cfg.num_layers):
            if cfg.layer_kind(i) != "attn":
                caches.append(init_ssm_cache(cfg, batch, self.tp, dev))
                continue
            shape = (batch, effective_kv_heads(cfg, self.tp),
                     self.kv_cache_len(max_seq), cfg.resolved_head_dim)
            caches.append(KVCache(
                torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                torch.zeros(shape, dtype=torch.bfloat16, device=dev)))
        return caches

    def decode_step(self, cache: list[KVCache | SSMCache],
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> tuple[torch.Tensor, list[KVCache | SSMCache]]:
        """tokens: [B, 1]; pos: [B] absolute positions.  Writes the caches
        in place and returns (logits [B, 1, padded vocab], cache)."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens).to(_dtype(cfg.dtype))
        for i, (bp, c) in enumerate(zip(self.blocks, cache)):
            h = apply_norm(bp.ln1, x, cfg)
            if cfg.layer_kind(i) == "attn":
                h, _ = decode_attention(bp.attn, h, cfg, c, pos)
            else:
                h, new = ssm_decode(bp.ssm, h, cfg, c)
                c.conv.copy_(new.conv)
                c.state.copy_(new.state)
            x = x + h
            if cfg.d_ff:
                x = x + apply_mlp(bp.mlp, apply_norm(bp.ln2, x, cfg), cfg)
        x = apply_norm(self.final_norm, x, cfg)
        return apply_unembed(self.embed, x, cfg), cache
