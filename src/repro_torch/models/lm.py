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

**Tensor parallelism** (the dense GQA and MLA, MoE, SSM and hybrid
families, :func:`tp_ported`, under a mesh whose ``model`` axis is larger
than 1):
the reference's GSPMD partitioning by ``make_rules`` as an explicit
per-rank program.  :meth:`LM.shard` gives one :class:`LM` a rank of the
mesh holding its blocks of the parameters (``spec_for(ParamSpec.axes,
rules, mesh)``: ``vocab``, ``heads``, ``mlp``, ``experts``,
``ssm_heads`` and ``q_lora`` over ``model``, ``embed`` and
``expert_mlp`` over ``data`` under FSDP), :meth:`LM.gather` writes them back.  ``apply`` inside a
rank that is manual over ``model`` runs :meth:`LM._apply_tp` (Megatron
form: vocabulary-parallel embedding, column-parallel q/k/v and MLP up,
row-parallel ``wo`` summed over ``model``, logits ``[B, S, V/tp]``); with
Megatron-SP (``S`` a multiple of ``tp``, ``S > 1``) the residual a rank
holds is ``[B, S/tp, d]`` (``seq_sp``): the sequence is all-gathered
before each block's column-parallel products and the partial products
reduce-scattered back.  An SSM layer is ``ssm_block`` on the rank's
blocks of the heads (``ssm_dims`` pads them to ``tp``; ``wB``, ``wC`` and
``conv_BC`` are whole, so every rank computes the full B and C, as GSPMD
does), a column- and row-parallel segment like attention: its conv,
scan, skip and gated RMSNorm are per channel or per head (the norm's mean
is over ``head_dim``), so its one collective is the sum of the partial
``wo`` product.  An MLA layer (:meth:`LM._mla_tp`) takes ``q_lora``
over ``model`` as the reference's rules do: the rank's block of the q
latent, the q RMSNorm's sum of squares psummed over ``model``, its
partial q (``wq_b``'s rows) reduce-scattered over ``model`` along the
heads, the latent and rope key whole (``wkv_a`` and ``kv_norm`` are
replicated), K and V of its heads, and its row-parallel ``wo`` product
summed like attention's.  A MoE layer is ``x + moe(ln2(x))`` on the rank's
own residual, the tokens the reference's ``shard_map`` gives the rank (a
sequence shard under Megatron-SP, else all of the rank's batch): the
reference's expert-parallel body (:func:`~.moe.moe_rank`) routes them with
the router gathered whole and exchanges them with ``all_to_all`` over the
rank's ``model`` group, which holds ``E / tp`` experts a rank; its aux
loss is ``pmean``-ed over every manual axis and summed over layers as
:meth:`LM.apply` sums them.  FSDP parameters are gathered over ``data``
with :func:`~repro_torch.parallel.spmd.gather_static` where they are
used (and again in the recompute).  With remat, only the rank-local
segments between collectives are checkpointed (norm -> projections ->
attention or the SSM mixer -> ``wo``; MLA's norm -> q latent, norm ->
partial q, norm -> latent -> attention -> ``wo``; norm -> MLP; norm ->
router -> buckets, the experts, the combine), so no recompute calls a
collective;
the gathered sequence each segment starts from is kept.  ``apply``
outside a rank runs the ranks under
:func:`~repro_torch.parallel.spmd.shard_map` (its rank modules cached
until a parameter of the model changes) and returns the logits
assembled from their vocabulary blocks and the ranks' aux loss.
The VLM and the encoder-decoder raise under a ``model`` axis larger than
1 (``models/model.py``).

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
from ..parallel import spmd
from ..parallel.sharding import (batch_axes, constrain, gather_shards,
                                 local_shape, mesh_axis_size, mesh_coords,
                                 padded, part_axes, shard_of, spec_for)
from . import params as prm
from .attention import (KVCache, attention_block, attention_block_tp,
                        attn_spec, decode_attention, effective_kv_heads)
from .layers import (apply_embed, apply_embed_tp, apply_mlp, apply_norm,
                     apply_unembed, embed_spec, mlp_spec, norm_spec)
from .mla import (MLACache, init_mla_cache, mla_attn_tp, mla_block,
                  mla_decode, mla_q_tp_a, mla_q_tp_b, mla_spec)
from .moe import moe_block, moe_rank, moe_spec, shared_expert
from .ssm import SSMCache, init_ssm_cache, ssm_block, ssm_decode, ssm_spec

__all__ = ["LM", "Block", "tp_ported", "TP_LEFT"]

TP_LEFT = "ROADMAP queue 1 item 1, left 6"


def tp_ported(cfg: ModelConfig) -> bool:
    """Whether tensor parallelism over ``model`` is ported for ``cfg``'s
    family: the dense GQA, MoE and hybrid families with GQA and RoPE, the
    dense MLA family, and the attention-free SSM family."""
    return (cfg.family, cfg.attention, cfg.pos_emb) in (
        ("dense", "gqa", "rope"), ("dense", "mla", "rope"),
        ("moe", "gqa", "rope"), ("hybrid", "gqa", "rope"),
        ("ssm", "none", "none"))


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
                 device=None, mesh=None, rules=None, tp: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.par = par or ParallelConfig()
        self.use_flash = use_flash
        self.use_ssd_kernel = use_ssd_kernel
        self.mesh, self.rules = mesh, rules
        # ``tp`` pads heads and vocabulary; it is the mesh's model axis
        # unless given (a one-device model of a partitioned one's tree)
        self.tp = tp if tp is not None else \
            (1 if mesh is None else mesh.shape.get("model", 1))
        self._ranks = None          # (parameter versions, rank modules)
        self._even = None           # every parameter splits evenly
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

    # ------------------------------------------------------------ ranks
    @property
    def partitioned(self) -> bool:
        """Whether the model runs tensor-parallel over its mesh's
        ``model`` axis: a ported family under a ``model`` axis > 1 whose
        every parameter splits evenly by its sharding (heads and
        vocabulary are padded to; a ``d_ff`` or, under FSDP, a
        ``d_model`` that does not divide keeps the one-device program)."""
        if self.mesh is None or self.rules is None or \
                self.mesh.shape.get("model", 1) <= 1 or \
                not tp_ported(self.cfg):
            return False
        if self._even is None:
            try:
                for path, sp in prm.tree_leaves_with_path(
                        self.param_spec()):
                    local_shape(sp.shape, spec_for(sp.axes, self.rules,
                                                   self.mesh), self.mesh)
                self._even = True
            except ValueError:
                self._even = False
        return self._even

    def in_tp_rank(self) -> bool:
        """Whether the caller is a rank of the partitioned program: the
        model is :attr:`partitioned` and ``model`` is a manual axis."""
        return self.partitioned and "model" in spmd.manual_axes()

    def param_specs(self) -> dict:
        """Each parameter's :class:`PartitionSpec` by its name
        (``"blocks.0.attn.wq"``) under the model's rules and mesh."""
        return {".".join(path): spec_for(sp.axes, self.rules, self.mesh)
                for path, sp in prm.tree_leaves_with_path(self.param_spec())}

    def shard(self) -> list["LM"]:
        """One model a rank of the mesh (rank order: row-major over its
        axes), each holding copies of its blocks of the parameters on its
        device: the inverse of :meth:`gather`."""
        specs, mesh = self.param_specs(), self.mesh
        ranks = []
        for c in mesh_coords(mesh):
            dev = mesh.devices[tuple(c[a] for a in mesh.axis_names)]
            rank = LM(self.cfg, self.par, self.use_flash,
                      self.use_ssd_kernel, "meta", mesh, self.rules, self.tp)
            for name, p in self.named_parameters():
                mod, key = prm.slot(rank, name)
                mod._parameters[key] = nn.Parameter(
                    shard_of(p.detach(), specs[name], mesh, c).to(
                        dev, copy=True), requires_grad=p.requires_grad)
            rank.coords = c
            ranks.append(rank)
        return ranks

    @torch.no_grad()
    def gather(self, ranks: list["LM"]) -> None:
        """Write the ranks' blocks (from :meth:`shard`) into the model's
        own parameters."""
        specs = self.param_specs()
        per = [dict(r.named_parameters()) for r in ranks]
        for name, p in self.named_parameters():
            p.copy_(gather_shards([d[name] for d in per], specs[name],
                                  self.mesh, p.device))
        self._ranks = (self._versions(), ranks)

    def _versions(self) -> tuple:
        return tuple((p.data_ptr(), p._version) for p in self.parameters())

    def tp_ranks(self) -> list["LM"]:
        """The rank modules ``apply`` runs: :meth:`shard` of the model,
        cached until one of its parameters changes."""
        key = self._versions()
        if self._ranks is None or self._ranks[0] != key:
            self._ranks = (key, self.shard())
        return self._ranks[1]

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
        if self.partitioned and embeds is None:
            if self.in_tp_rank():
                return self._apply_tp(tokens, positions)
            if not spmd.in_rank():
                return self._apply_ranks(tokens, positions)
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

    def _apply_ranks(self, tokens: torch.Tensor, positions):
        """The partitioned program over the mesh's ranks: (logits [B, S,
        padded vocab] assembled from the ranks' vocabulary blocks on the
        mesh's first device, the ranks' aux loss)."""
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
        ba = batch_axes(self.mesh, B)
        ranks = self.tp_ranks()

        def local(t, pos):
            return ranks[spmd.rank_index()].apply(t, pos)

        return spmd.shard_map(
            local, mesh=self.mesh, in_specs=(spmd.P(ba), spmd.P(ba)),
            out_specs=(spmd.P(ba, None, "model"), spmd.P()))(tokens,
                                                              positions)

    def _fsdp_gather(self):
        """``gather(params)`` for a dict of this rank's parameters: each one
        sharded over a manual data axis (FSDP's ``embed`` and
        ``expert_mlp``) gathered with its group's blocks, and a MoE router
        whole, over ``model`` too (the reference's ``shard_map`` takes it
        replicated), with :func:`~repro_torch.parallel.spmd.
        gather_static`; the others as they are."""
        specs = self.param_specs()
        sizes = self.mesh.shape
        manual = spmd.manual_axes()
        names, where, groups = {}, {}, {}
        for name, p in self.named_parameters():
            whole = name.endswith(".moe.router")
            dims, axes = [], []
            for d, part in enumerate(specs[name]):
                for a in part_axes(part):
                    if (a != "model" or whole) and a in manual and \
                            sizes[a] > 1:
                        dims.append(d)
                        axes.append(a)
            if axes:
                axes = tuple(axes)
                names[id(p)], where[name] = name, (tuple(dims), axes)
                groups.setdefault(axes, {})[name] = p
        if not where:
            return lambda pd: pd
        peers = {axes: spmd.peers(objs, axes)
                 for axes, objs in sorted(groups.items())}

        def gather(pd) -> dict:
            out = {}
            for k, t in pd.items():
                name = names.get(id(t))
                if name is None:
                    out[k] = t
                    continue
                dims, axes = where[name]
                pe = peers[axes]
                out[k] = spmd.gather_static(
                    [m[name] for m in pe.items], dims, t.device, axes,
                    pe.counts, tuple(sizes[a] for a in axes))
            return out

        return gather

    def _apply_tp(self, tokens: torch.Tensor, positions):
        """One tensor-parallel rank's prefill forward (see the module
        docstring): (its logits block [B, S, V_padded / tp], the MoE
        layers' aux loss, the same on every rank)."""
        cfg, mesh, rules = self.cfg, self.mesh, self.rules
        tp, r = spmd.axis_size("model"), spmd.axis_index("model")
        B, S = tokens.shape
        dt = _dtype(cfg.dtype)
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
        bg = B * mesh_axis_size(mesh, tuple(
            a for a in rules["batch"] or () if a in spmd.manual_axes()))
        sp = S % tp == 0 and S > 1
        remat = self.par.remat != "none" and torch.is_grad_enabled()
        gather = self._fsdp_gather()

        def reduce(part):
            return spmd.psum_scatter(part, "model", 1) if sp else \
                spmd.psum(part, "model")

        def gathered(x):
            return spmd.all_gather(x, "model", 1) if sp else x

        def across(segment, x):
            """The sum over ``model`` of ``segment`` on the (gathered)
            residual; only the rank-local segment is recomputed."""
            h = gathered(x)
            part = checkpoint(segment, h, use_reentrant=False) if remat \
                else segment(h)
            return reduce(part)

        def sub(segment, x):
            return x + across(segment, x)

        x = reduce(apply_embed_tp(gather(self.embed), tokens, r).to(dt))
        seq = ("batch", "seq_sp" if sp else "seq", "act_embed")
        x = constrain(x, seq, rules, mesh, (bg, S, cfg.d_model))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = group = zero
        for i, bp in enumerate(self.blocks):
            if self.layer_kind(i) == "attn" and cfg.attention == "mla":
                x = x + reduce(self._mla_tp(bp, gathered(x), positions,
                                            gather, remat, r))
            elif self.layer_kind(i) == "attn":
                x = sub(lambda h, bp=bp: attention_block_tp(
                    gather(bp.attn), apply_norm(bp.ln1, h, cfg), cfg,
                    positions, self.use_flash, r, tp), x)
            else:
                x = sub(lambda h, bp=bp: ssm_block(
                    gather(bp.ssm), apply_norm(bp.ln1, h, cfg), cfg,
                    self.use_ssd_kernel), x)
            if "mlp" in bp._modules:
                x = sub(lambda h, bp=bp: apply_mlp(
                    gather(bp.mlp), apply_norm(bp.ln2, h, cfg), cfg), x)
            elif "moe" in bp._modules:
                y, a = self._moe_tp(bp, x, gather, across, remat)
                x, group = x + y, group + a
            if (i + 1) % self.period == 0:
                aux, group = aux + group, zero
                x = constrain(x, seq, rules, mesh, (bg, S, cfg.d_model))
        if sp:
            x = spmd.all_gather(x, "model", 1)
        x = apply_norm(self.final_norm, x, cfg)
        logits = apply_unembed(gather(self.embed), x, cfg)
        logits = constrain(logits, ("batch", "seq", "act_heads"), rules,
                           mesh, (bg, S, self.vocab_padded))
        return logits, aux

    def _mla_tp(self, bp: Block, h: torch.Tensor, positions, gather,
                remat: bool, rank: int) -> torch.Tensor:
        """An MLA layer's attention on the rank's gathered residual ``h``
        (``models/mla.py``): the sum of squares of its block of the q
        latent psummed over ``model``, its partial q reduce-scattered over
        ``model`` along the heads, and its partial ``wo`` product, which
        the caller sums.  With remat the three rank-local pieces between
        the collectives are checkpointed apart (each of the first and the
        last normalizes ``h`` itself, so only ``h`` is held), so no
        recompute calls a collective and the collectives' outputs are
        kept; without remat the norm runs once."""
        cfg, attn = self.cfg, bp.attn

        def run(piece, *args):
            return checkpoint(piece, *args, use_reentrant=False) if remat \
                else piece(*args)

        def held(*keys) -> dict:
            return gather({k: attn[k] for k in keys})

        def norm(h):
            return apply_norm(bp.ln1, h, cfg) if remat else h

        if not remat:
            h = apply_norm(bp.ln1, h, cfg)
        ql, sq = run(lambda h: mla_q_tp_a(held("wq_a")["wq_a"], norm(h)), h)
        sq = spmd.psum(sq, "model")
        q = run(lambda ql, sq: mla_q_tp_b(held("q_norm", "wq_b"), ql, sq,
                                          cfg, rank), ql, sq)
        q = spmd.psum_scatter(q, "model", 2)
        return run(lambda h, q: mla_attn_tp(
            held("wkv_a", "kv_norm", "wk_b", "wv_b", "wo"), norm(h), q, cfg,
            positions, self.use_flash), h, q)

    def _moe_tp(self, bp: Block, x: torch.Tensor, gather, across,
                remat: bool):
        """A MoE layer's FFN on the rank's residual ``x`` (the
        reference's ``shard_map`` tokens: a sequence shard under
        Megatron-SP, else every token of the rank's batch): (y, aux).  The
        routed experts dispatch over the rank's ``model`` group
        (:func:`~.moe.moe_rank`, router gathered whole, experts over
        ``data`` under FSDP, inside its remat segments); a shared expert is
        column-parallel over ``model`` as the MLP is (``across``)."""
        cfg, moe = self.cfg, bp.moe

        def norm(h):
            return apply_norm(bp.ln2, h, cfg)

        y, aux = moe_rank(lambda k: gather({k: moe[k]})[k], x, cfg, norm,
                          remat)
        if cfg.moe.shared_expert_d_ff:
            def shared(h):
                g = gather({k: moe[k] for k in ("shared_wi", "shared_wo")})
                return shared_expert(g["shared_wi"], g["shared_wo"],
                                     norm(h), cfg)
            y = y + across(shared, x)
        return y, aux

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
