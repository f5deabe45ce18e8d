"""Decoder-only LM assembly for the dense GQA, MLA, M-RoPE (VLM), MoE,
Mamba-2 SSM and hybrid families.

The port of ``repro/models/lm.py``.  The reference groups layers into
*periods*, the repeating pattern of sub-layers (``lcm(attn_every,
moe_every)`` layers: 1 for homogeneous stacks, 8 for jamba), keys each
period position's parameters
``block_<i>`` with a leading ``[n_groups]`` axis and scans over groups.
The port keeps one :class:`Block` per layer in an ``nn.ModuleList`` and
loops (``models/convert.py`` maps layer ``l`` to ``block_<l % period>``'s
entry ``l // period``).  A layer's kind is asked of its position *in the
period*, as the reference asks it: ``cfg.layer_kind(l % period)`` picks
the mixer (``attn`` or ``ssm``) and ``cfg.is_moe_layer(l % period)`` the
FFN (``moe``, or ``mlp`` when ``d_ff`` is set), each after ``ln2``.  So
``MoEConfig.first_k_dense`` makes the first k positions of *every* period
dense, not the first k layers (ROADMAP, "Known behaviours").

The model owns its parameters: ``apply``, ``init_cache`` and
``decode_step`` take no parameter tree.  ``mesh=``/``rules=`` are the
reference's: the tensor-parallel width ``tp`` is the mesh's ``model``
axis, heads and vocabulary are padded to it as the reference pads them,
MoE layers dispatch expert-parallel over it (``moe_block``), and
:func:`~repro_torch.parallel.sharding.constrain` is called where the
reference calls it (it leaves values as they are).  ``apply`` returns the
MoE layers' aux losses summed per period group in layer order, then over
groups.  With ``par.remat`` other than ``"none"`` each block runs under
``torch.utils.checkpoint`` when gradients are taken: per layer, which is
the reference's per-group ``jax.checkpoint`` at period 1 and its per
sub-layer checkpoint under ``remat="full"`` at period > 1.

MLA layers (``cfg.attention == "mla"``) keep their parameters under
``attn`` as the reference does and one :class:`~.mla.MLACache` (latent and
rope key, no window) a layer for decode.  The VLM's stub frontend feeds
``apply(embeds=[B, S, d], positions=[B, S, 3])``.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, ParallelConfig
from ..parallel.sharding import constrain, padded
from . import params as prm
from .attention import (KVCache, attention_block, attn_spec, decode_attention,
                        effective_kv_heads)
from .layers import (apply_embed, apply_mlp, apply_norm, apply_unembed,
                     embed_spec, mlp_spec, norm_spec)
from .mla import MLACache, init_mla_cache, mla_block, mla_decode, mla_spec
from .moe import moe_block, moe_spec
from .ssm import SSMCache, init_ssm_cache, ssm_block, ssm_decode, ssm_spec

__all__ = ["LM", "Block"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Block(nn.Module):
    """One layer: norm, mixer (attention or SSM), and norm and FFN (MLP or
    MoE) when the layer has one, each a dict of parameters under the
    reference's names."""

    def __init__(self, spec: dict, device):
        super().__init__()
        for name, sub in spec.items():
            self.add_module(name, prm.module_from_spec(sub, device))


class LM(nn.Module):
    """Decoder: embedding, ``num_layers`` blocks, final norm, (tied)
    unembedding.  Built without values; :meth:`init` draws them.
    ``use_flash`` sends full-sequence attention through the flash kernels,
    ``use_ssd_kernel`` the SSM mixer's scan through the SSD kernel; ``mesh``
    (a :class:`~repro_torch.launch.mesh.Mesh`) and ``rules`` (a sharding
    rules table) are the reference's."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig | None = None,
                 use_flash: bool = False, use_ssd_kernel: bool = False,
                 device=None, mesh=None, rules=None):
        super().__init__()
        self.cfg = cfg
        self.par = par or ParallelConfig()
        self.use_flash = use_flash
        self.use_ssd_kernel = use_ssd_kernel
        self.mesh, self.rules = mesh, rules
        self.tp = 1 if mesh is None else mesh.shape.get("model", 1)
        self.vocab_padded = padded(cfg.vocab_size, self.tp * 128)
        self.period = cfg.attn_every or 1
        if cfg.moe is not None and cfg.moe_every > 1:
            self.period = math.lcm(self.period, cfg.moe_every)
        if cfg.num_layers % self.period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole periods of {self.period}")
        self.n_groups = cfg.num_layers // self.period
        spec = self.param_spec()
        self.embed = prm.module_from_spec(spec["embed"], device)
        self.blocks = nn.ModuleList(
            Block(spec["blocks"][str(i)], device)
            for i in range(cfg.num_layers))
        self.final_norm = prm.module_from_spec(spec["final_norm"], device)

    # ------------------------------------------------------------ specs
    def layer_kind(self, i: int) -> str:
        """Layer ``i``'s mixer, ``"attn"`` or ``"ssm"``: the config's kind
        of its position in the period."""
        return self.cfg.layer_kind(i % self.period)

    def _block_spec(self, i: int) -> dict:
        cfg, n, pos = self.cfg, self.n_groups, i % self.period
        d: dict = {"ln1": norm_spec(cfg, n)}
        if cfg.layer_kind(pos) == "attn":
            d["attn"] = (mla_spec if cfg.attention == "mla" else attn_spec)(
                cfg, self.tp, n)
        else:
            d["ssm"] = ssm_spec(cfg, self.tp, n)
        if cfg.d_ff or cfg.is_moe_layer(pos):
            d["ln2"] = norm_spec(cfg, n)
            if cfg.is_moe_layer(pos):
                d["moe"] = moe_spec(cfg, n)
            else:
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

    def abstract_params(self) -> dict:
        """The parameter tree as ``ShapeDtypeStruct``s with their shardings
        under the model's rules and mesh; nothing is allocated."""
        return prm.abstract_tree(self.param_spec(), self.rules, self.mesh)

    def param_shardings(self) -> dict:
        """Each parameter's sharding under the model's rules and mesh."""
        return prm.shardings_tree(self.param_spec(), self.rules, self.mesh)

    # ------------------------------------------------------------ forward
    def _ffn(self, bp: Block, x: torch.Tensor):
        """The layer's FFN on ``x`` (after ``ln2``): ``(out, aux)``, aux
        None for an MLP; ``(None, None)`` for a layer without one."""
        if "moe" in bp._modules:
            return moe_block(bp.moe, apply_norm(bp.ln2, x, self.cfg),
                             self.cfg, self.rules, self.mesh)
        if "mlp" in bp._modules:
            return apply_mlp(bp.mlp, apply_norm(bp.ln2, x, self.cfg),
                             self.cfg), None
        return None, None

    def _apply_block(self, bp: Block, i: int, x: torch.Tensor,
                     positions: torch.Tensor):
        """Layer ``i`` on ``x``: ``(x, aux)``, aux None without MoE."""
        cfg = self.cfg
        h = apply_norm(bp.ln1, x, cfg)
        if self.layer_kind(i) == "attn":
            block = mla_block if cfg.attention == "mla" else attention_block
            h = block(bp.attn, h, cfg, positions, self.use_flash)
        else:
            h = ssm_block(bp.ssm, h, cfg, self.use_ssd_kernel)
        x = x + h
        h, aux = self._ffn(bp, x)
        x = x if h is None else x + h
        return constrain(x, ("batch", "seq", "act_embed"), self.rules,
                         self.mesh), aux

    def apply(self, tokens: torch.Tensor | None = None,
              positions: torch.Tensor | None = None,
              embeds: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefill forward.

        tokens: [B, S] integer (or ``embeds`` [B, S, d], the VLM's stub
        frontend).  positions: [B, S], or [B, S, 3] (t, h, w) for M-RoPE,
        which raises ``ValueError`` without them.  Returns (logits [B, S,
        padded vocab], aux): aux is the MoE layers' load-balancing loss, 0
        without MoE layers.
        """
        cfg = self.cfg
        dt = _dtype(cfg.dtype)
        x = (apply_embed(self.embed, tokens) if embeds is None
             else embeds).to(dt)
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        x = constrain(x, ("batch", "seq", "act_embed"), self.rules, self.mesh)
        # residuals at period-group boundaries are sequence-sharded over
        # the TP axis (Megatron-SP) in the reference
        sp_ok = S % (self.tp or 1) == 0 and S > 1
        remat = self.par.remat != "none" and torch.is_grad_enabled()
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = group = zero
        for i, bp in enumerate(self.blocks):
            if remat:
                x, a = checkpoint(self._apply_block, bp, i, x, positions,
                                  use_reentrant=False)
            else:
                x, a = self._apply_block(bp, i, x, positions)
            if a is not None:
                group = group + a
            if (i + 1) % self.period == 0:
                aux, group = aux + group, zero
                if sp_ok:
                    x = constrain(x, ("batch", "seq_sp", "act_embed"),
                                  self.rules, self.mesh)
        x = apply_norm(self.final_norm, x, cfg)
        logits = apply_unembed(self.embed, x, cfg)
        logits = constrain(logits, ("batch", "seq", "act_heads"),
                           self.rules, self.mesh)
        return logits, aux

    # ------------------------------------------------------------ decode
    def kv_cache_len(self, max_seq: int) -> int:
        """Positions a layer's KV cache holds: ``min(max_seq, window)`` for
        sliding windows, else ``max_seq`` (MLA's latent cache too: the
        port builds MLA without a window)."""
        w = self.cfg.sliding_window
        return min(max_seq, w) if w else max_seq

    def init_cache(self, batch: int, max_seq: int
                   ) -> list[KVCache | MLACache | SSMCache]:
        """One cache per layer: a bf16 KV cache ``[batch, kv_heads, S,
        head_dim]`` (``S`` = :meth:`kv_cache_len`) for attention, a bf16
        latent and rope-key cache (:func:`~.mla.init_mla_cache`) for MLA, a
        conv window and float32 state (:func:`~.ssm.init_ssm_cache`) for
        SSM layers."""
        cfg = self.cfg
        dev = self.final_norm["scale"].device
        caches: list = []
        for i in range(cfg.num_layers):
            if self.layer_kind(i) != "attn":
                caches.append(init_ssm_cache(cfg, batch, self.tp, dev))
                continue
            if cfg.attention == "mla":
                caches.append(init_mla_cache(cfg, batch, max_seq, dev))
                continue
            shape = (batch, effective_kv_heads(cfg, self.tp),
                     self.kv_cache_len(max_seq), cfg.resolved_head_dim)
            caches.append(KVCache(
                torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                torch.zeros(shape, dtype=torch.bfloat16, device=dev)))
        return caches

    def decode_step(self, cache: list[KVCache | MLACache | SSMCache],
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> tuple[torch.Tensor,
                               list[KVCache | MLACache | SSMCache]]:
        """tokens: [B, 1]; pos: [B] absolute positions.  Writes the caches
        in place and returns (logits [B, 1, padded vocab], cache).  MoE
        layers route the step's B tokens together (so a slot's output can
        depend on the other slots' tokens through capacity drops, as in
        the reference), and their aux losses are dropped."""
        cfg = self.cfg
        x = apply_embed(self.embed, tokens).to(_dtype(cfg.dtype))
        x = constrain(x, ("batch", None, "act_embed"), self.rules, self.mesh)
        for i, (bp, c) in enumerate(zip(self.blocks, cache)):
            h = apply_norm(bp.ln1, x, cfg)
            if self.layer_kind(i) == "attn":
                step = mla_decode if cfg.attention == "mla" \
                    else decode_attention
                h, _ = step(bp.attn, h, cfg, c, pos)
            else:
                h, new = ssm_decode(bp.ssm, h, cfg, c)
                c.conv.copy_(new.conv)
                c.state.copy_(new.state)
            x = x + h
            h, _ = self._ffn(bp, x)
            if h is not None:
                x = x + h
        x = apply_norm(self.final_norm, x, cfg)
        return apply_unembed(self.embed, x, cfg), cache
