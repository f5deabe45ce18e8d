"""Encoder-decoder backbone (whisper-large-v3).

The port of ``repro/models/encdec.py``.  The conv/mel frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings [B,
S_enc, d_model].  Encoder layers are pre-LN bidirectional self-attention
(plain, never the kernel: the reference calls it with ``cross=True,
use_flash=False``) and a GELU MLP; decoder layers add causal
self-attention (through the flash kernel when ``use_flash``; a bf16 KV
cache at decode) and cross attention to the encoder's output (plain; its
K/V computed once a request by :meth:`EncDec.init_cache`).  Both position
tables are learned and wrap (``pe[arange(S) % rows]``).

The reference stacks each leaf over layers (``encoder``/``decoder``
``[E, ...]``/``[L, ...]``) and scans; the port keeps one
:class:`~.lm.Block` a layer (``models/convert.py`` maps them) and loops.
The model owns its parameters, as :class:`~.lm.LM` does, and takes the
reference's ``mesh=``/``rules=`` as it does (``tp`` from the mesh's
``model`` axis; ``constrain`` where the reference calls it).  The reference
has no serving engine for it: it is served through :meth:`init_cache` and
:meth:`decode_step`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, ParallelConfig
from ..parallel.sharding import constrain, padded
from . import params as prm
from .attention import (KVCache, _out, _proj, attn_spec, decode_attention,
                        effective_kv_heads, flash_or_ref, project_qkv)
from .layers import (apply_embed, apply_mlp, apply_norm, apply_unembed,
                     embed_spec, learned_pos_spec, mlp_spec, norm_spec)
from .lm import Block

__all__ = ["EncDec", "EncDecCache"]


class EncDecCache(NamedTuple):
    self_kv: list[KVCache]          # a layer's [B, Hkv, max_seq, hd], bf16
    cross_k: list[torch.Tensor]     # a layer's [B, S_enc, Hkv, hd]
    cross_v: list[torch.Tensor]


class EncDec(nn.Module):
    """Embedding (tied unembedding), learned decoder and encoder positions,
    ``encoder_layers`` encoder blocks, ``num_layers`` decoder blocks and
    the two final norms.  Built without values; :meth:`init` draws them."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig | None = None,
                 use_flash: bool = False, device=None, mesh=None,
                 rules=None):
        super().__init__()
        self.cfg = cfg
        self.par = par or ParallelConfig()
        self.use_flash = use_flash
        self.mesh, self.rules = mesh, rules
        self.tp = 1 if mesh is None else mesh.shape.get("model", 1)
        self.vocab_padded = padded(cfg.vocab_size, self.tp * 128)
        spec = self.param_spec()
        for name in ("embed", "dec_pos", "enc_pos", "enc_norm",
                     "final_norm"):
            self.add_module(name, prm.module_from_spec(spec[name], device))
        for name in ("encoder", "decoder"):
            self.add_module(name, nn.ModuleList(
                Block(spec[name][str(i)], device)
                for i in range(len(spec[name]))))

    # ------------------------------------------------------------ specs
    def param_spec(self) -> dict:
        """The parameter tree, one entry per layer under ``encoder`` and
        ``decoder``."""
        cfg, E, L = self.cfg, self.cfg.encoder_layers, self.cfg.num_layers
        enc = {"ln1": norm_spec(cfg, E), "attn": attn_spec(cfg, self.tp, E),
               "ln2": norm_spec(cfg, E), "mlp": mlp_spec(cfg, cfg.d_ff, E)}
        dec = {"ln1": norm_spec(cfg, L),
               "self_attn": attn_spec(cfg, self.tp, L),
               "ln_x": norm_spec(cfg, L),
               "cross_attn": attn_spec(cfg, self.tp, L),
               "ln2": norm_spec(cfg, L), "mlp": mlp_spec(cfg, cfg.d_ff, L)}
        return {"embed": embed_spec(cfg, self.vocab_padded),
                "dec_pos": learned_pos_spec(cfg, cfg.max_position),
                "enc_pos": learned_pos_spec(cfg, cfg.encoder_seq),
                "encoder": {str(i): enc for i in range(E)},
                "decoder": {str(i): dec for i in range(L)},
                "enc_norm": norm_spec(cfg),
                "final_norm": norm_spec(cfg)}

    def init(self, generator: torch.Generator) -> "EncDec":
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

    def _dt(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def _layers(self, body, blocks, x: torch.Tensor, *args) -> torch.Tensor:
        """``x`` through ``body(block, x, *args)`` for each block, each
        recomputed in the backward under ``par.remat`` when gradients are
        taken; each output constrained as the reference's scan body does."""
        remat = self.par.remat != "none" and torch.is_grad_enabled()
        sp = "seq_sp" if x.shape[1] % max(self.tp, 1) == 0 else "seq"
        for bp in blocks:
            x = checkpoint(body, bp, x, *args, use_reentrant=False) \
                if remat else body(bp, x, *args)
            x = constrain(x, ("batch", sp, "act_embed"), self.rules,
                          self.mesh)
        return x

    # ------------------------------------------------------------ encoder
    def _enc_block(self, bp: Block, x: torch.Tensor, positions):
        cfg = self.cfg
        h = apply_norm(bp.ln1, x, cfg)
        q, k, v = project_qkv(bp.attn, h, cfg, positions, rope=False)
        o = flash_or_ref(q, k, v, positions, positions, cross=True,
                         use_flash=False)
        x = x + _out(o, bp.attn["wo"])
        return x + apply_mlp(bp.mlp, apply_norm(bp.ln2, x, cfg), cfg)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, S_enc, d] stub embeddings -> encoder states."""
        B, S, _ = frames.shape
        pe = self.enc_pos["pos_embedding"]
        ar = torch.arange(S, device=frames.device)
        x = frames.to(self._dt()) + pe[ar % pe.shape[0]].to(self._dt())
        positions = ar.to(torch.int32).expand(B, S)
        x = constrain(x, ("batch", "seq", "act_embed"), self.rules, self.mesh)
        x = self._layers(self._enc_block, self.encoder, x, positions)
        return apply_norm(self.enc_norm, x, self.cfg)

    # ------------------------------------------------------------ decoder
    def _cross(self, bp: Block, x: torch.Tensor, k, v) -> torch.Tensor:
        """Cross attention of ``x`` (after ``ln_x``) to the encoder's
        ``k``/``v`` [B, S_enc, Hkv, hd]: unmasked, plain."""
        h = apply_norm(bp.ln_x, x, self.cfg)
        q = _proj(h, bp.cross_attn["wq"])
        o = flash_or_ref(q, k, v, None, None, cross=True)
        return _out(o, bp.cross_attn["wo"])

    def _dec_block(self, bp: Block, x: torch.Tensor, positions, enc_out):
        cfg = self.cfg
        h = apply_norm(bp.ln1, x, cfg)
        q, k, v = project_qkv(bp.self_attn, h, cfg, positions, rope=False)
        o = flash_or_ref(q, k, v, positions, positions,
                         use_flash=self.use_flash)
        x = x + _out(o, bp.self_attn["wo"])
        ca = bp.cross_attn
        x = x + self._cross(bp, x, _proj(enc_out, ca["wk"]),
                            _proj(enc_out, ca["wv"]))
        return x + apply_mlp(bp.mlp, apply_norm(bp.ln2, x, cfg), cfg)

    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor
                     ) -> torch.Tensor:
        """Teacher-forced decoder pass.  Returns logits [B, S, padded
        vocab]."""
        B, S = tokens.shape
        pe = self.dec_pos["pos_embedding"]
        ar = torch.arange(S, device=tokens.device)
        x = apply_embed(self.embed, tokens).to(self._dt())
        x = x + pe[ar % pe.shape[0]].to(x.dtype)
        positions = ar.to(torch.int32).expand(B, S)
        x = self._layers(self._dec_block, self.decoder, x, positions,
                         enc_out)
        x = apply_norm(self.final_norm, x, self.cfg)
        return apply_unembed(self.embed, x, self.cfg)

    def apply(self, tokens: torch.Tensor, frames: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, S, padded vocab], 0): the reference's return shape,
        with no aux loss."""
        logits = self.decode_train(tokens, self.encode(frames))
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    # ------------------------------------------------------------ serving
    def init_cache(self, enc_out: torch.Tensor, max_seq: int) -> EncDecCache:
        """A bf16 self-attention KV cache of ``max_seq`` positions a
        decoder layer, and each layer's cross K/V of ``enc_out`` [B, S_enc,
        d], computed once."""
        cfg = self.cfg
        shape = (enc_out.shape[0], effective_kv_heads(cfg, self.tp),
                 max_seq, cfg.resolved_head_dim)
        kv = [KVCache(*(torch.zeros(shape, dtype=torch.bfloat16,
                                    device=enc_out.device)
                        for _ in range(2)))
              for _ in self.decoder]
        return EncDecCache(
            kv, [_proj(enc_out, bp.cross_attn["wk"]) for bp in self.decoder],
            [_proj(enc_out, bp.cross_attn["wv"]) for bp in self.decoder])

    def decode_step(self, cache: EncDecCache, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, EncDecCache]:
        """tokens: [B, 1]; pos: [B] absolute positions (the position table
        wraps at ``max_position``; the KV cache must hold ``pos``).  Writes
        the self-attention caches in place and returns (logits [B, 1,
        padded vocab], cache)."""
        cfg = self.cfg
        pe = self.dec_pos["pos_embedding"]
        x = apply_embed(self.embed, tokens).to(self._dt())
        x = x + pe[pos % pe.shape[0]][:, None].to(x.dtype)
        for bp, kv, ck, cv in zip(self.decoder, *cache):
            h, _ = decode_attention(bp.self_attn,
                                    apply_norm(bp.ln1, x, cfg), cfg, kv, pos)
            x = x + h
            x = x + self._cross(bp, x, ck, cv)
            x = x + apply_mlp(bp.mlp, apply_norm(bp.ln2, x, cfg), cfg)
        x = apply_norm(self.final_norm, x, cfg)
        return apply_unembed(self.embed, x, cfg), cache
