"""Train / prefill / decode step builders and the abstract inputs of every
assigned (architecture x shape) cell.

The port of ``repro/launch/steps.py``.  ``build_cell(arch, shape_name,
mesh, ...)`` returns a :class:`Cell` whose ``fn`` is a plain function on
tensors and whose ``args`` are :class:`~repro_torch.models.params.
ShapeDtypeStruct`s carrying their shardings on ``mesh``, as the
reference's are ``jax.ShapeDtypeStruct``s: the dry-run
(``launch/dryrun.py``) sizes and counts a cell from them without running
it on a device, and :func:`materialize` turns them into tensors.

The port's model owns its parameters, so ``fn`` binds the parameter tree
it is handed to the cell's model (built on the meta device, holding
nothing) for the length of the call: the model's parameter slots then hold
the argument tensors themselves (for training, detached views of them
that take gradients).  The port keeps one tree entry a layer where the
reference stacks ``[n_groups]`` (``models/params.py``), and one cache a
layer: each cache leaf's sharding is the reference's per-leaf sharding
(``:338-383``) without the stacked axis.  ``donate`` keeps the reference's
argnums, and the port honours it: ``adamw_update`` writes the parameters
and the optimizer state in place and ``decode_step`` the cache, so those
outputs are the donated inputs themselves.  The optimizer's step counter
is the exception: ``adamw_update`` returns a new one.

``fn`` runs what one device runs when the mesh has a single device.  A
dense GQA or MLA, MoE, SSM or hybrid ``train`` or ``prefill`` cell on a
mesh whose ``model`` axis is larger than 1 is *partitioned*
(``Cell.partitioned``): its ``fn`` is one rank's program
(``models/lm.py``'s tensor-parallel forward, the SSM mixer on the rank's
heads and the MoE's expert dispatch over the rank's ``model`` group among
it, the vocabulary-parallel :func:`cross_entropy_tp`, :func:`~repro_torch.
collectives.scheduler.sync_grads_tp` and AdamW on the rank's blocks),
run inside a rank that is manual over every mesh axis on the rank's
blocks of the args (:func:`~repro_torch.launch.dryrun.rank_share`); the
dry-run runs it alone (``spmd.lone_rank``), and the real ranks' training
step is ``runtime.make_train_step``'s.  Every other cell on a larger mesh
(the decode cells, whose tensor parallelism is ROADMAP queue 1 item 1,
left 6 item 6, and the VLM and encoder-decoder cells, left 6) runs
one rank's share of the batch at full model width.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from .. import flags
from ..config import ModelConfig, ParallelConfig, ShapeSpec, TrainConfig
from ..configs import registry
from ..models.attention import KVCache
from ..models.encdec import EncDecCache
from ..models.mla import MLACache
from ..models.model import make_model
from ..models.params import (ShapeDtypeStruct, abstract_tree, count_params,
                             init_leaf, slot, tree_leaves_with_path,
                             unflatten)
from ..models.ssm import SSMCache
from ..collectives.scheduler import sync_grads_tp
from ..optim.adamw import OptState, adamw_update
from ..parallel import spmd
from ..parallel.sharding import (NamedSharding, batch_axes, make_rules,
                                 spec_axes)
from ..parallel.spmd import PartitionSpec as P

__all__ = ["ARCH_POLICY", "make_parallel_config", "make_train_config",
           "cross_entropy", "cross_entropy_tp", "model_loss", "Cell",
           "active_param_count", "build_cell", "materialize"]

# ---------------------------------------------------------------------------
# per-arch parallel/training policy

ARCH_POLICY: dict[str, dict[str, Any]] = {
    "mamba2_130m":         dict(fsdp=False, remat="block",
                                opt_dtype="float32", master=True, accum=1),
    "minicpm3_4b":         dict(fsdp=False, remat="block",
                                opt_dtype="float32", master=True, accum=2),
    "h2o_danube_3_4b":     dict(fsdp=False, remat="block",
                                opt_dtype="float32", master=True, accum=2),
    "nemotron_4_15b":      dict(fsdp=True, remat="block",
                                opt_dtype="float32", master=True, accum=4),
    "nemotron_4_340b":     dict(fsdp=True, remat="block",
                                opt_dtype="bfloat16", master=False, accum=16),
    "granite_moe_1b_a400m": dict(fsdp=False, remat="block",
                                 opt_dtype="float32", master=True, accum=2),
    "kimi_k2_1t_a32b":     dict(fsdp=True, remat="block",
                                opt_dtype="bfloat16", master=False, accum=16),
    "whisper_large_v3":    dict(fsdp=True, remat="block",
                                opt_dtype="float32", master=True, accum=8),
    "jamba_v0_1_52b":      dict(fsdp=True, remat="full",
                                opt_dtype="bfloat16", master=False, accum=8),
    "qwen2_vl_2b":         dict(fsdp=False, remat="block",
                                opt_dtype="float32", master=True, accum=1),
}


def make_parallel_config(arch: str, shape_name: str) -> ParallelConfig:
    pol = ARCH_POLICY[registry.canonical(arch)]
    return ParallelConfig(fsdp=pol["fsdp"], remat=pol["remat"],
                          scan_layers=True, grad_sync="xla",
                          seq_shard_decode=shape_name.startswith("long"))


def make_train_config(arch: str, spec: ShapeSpec) -> TrainConfig:
    pol = ARCH_POLICY[registry.canonical(arch)]
    return TrainConfig(global_batch=spec.global_batch, seq_len=spec.seq_len,
                       opt_state_dtype=pol["opt_dtype"],
                       master_weights=pol["master"])


# ---------------------------------------------------------------------------


@dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable                  # step function on tensors
    args: tuple                   # ShapeDtypeStructs (dry-run) or tensors
    donate: tuple[int, ...]       # argnums whose storage fn reuses
    model_params: int             # true (unpadded) parameter count
    active_params: int            # active params per token (MoE-aware)
    notes: str = ""
    model: Any = None             # the model fn binds its parameters to
    batch_args: tuple[int, ...] = ()   # argnums split over the batch axes
    accum: int = 1                # microbatches a train step
    partitioned: bool = False     # fn is one rank's tensor-parallel program


def _sh(mesh, *parts) -> NamedSharding:
    return NamedSharding(mesh, P(*parts))


def _struct(shape, dtype, sharding=None) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(int(s) for s in shape), dtype, sharding)


def _kv_seq_axes(mesh, shape_name: str, ba):
    """Decode KV caches shard their sequence axis over 'model' (+ idle data
    axes for long-context): distributed flash-decode."""
    axes = ["model"]
    used = set(ba or ())
    if shape_name.startswith("long"):
        for a in ("data", "pod"):
            if a in mesh.shape and a not in used:
                axes.insert(0, a)
    return tuple(axes)


def active_param_count(cfg: ModelConfig, total: int) -> int:
    """Active params per token: subtract unrouted expert weights."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = m.d_ff_expert * cfg.d_model * \
        (3 if cfg.activation == "swiglu" else 2)
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    inactive = n_moe * (m.num_experts - m.experts_per_token) * per_expert
    return total - inactive


# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh,
               abstract: bool = True, policy_overrides: dict | None = None,
               depth_override: int | None = None) -> Cell:
    """The cell of ``arch`` at ``shape_name`` on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`).  ``abstract=False`` replaces
    the abstract args by tensors on the mesh's first device
    (:func:`materialize`, seed 0), where the port's single controller keeps
    global values."""
    arch = registry.canonical(arch)
    cfg = registry.get_config(arch)
    if depth_override is not None:
        repl = {"num_layers": depth_override}
        if cfg.encoder_layers:
            repl["encoder_layers"] = depth_override
        cfg = dataclasses.replace(cfg, **repl)
    spec = next(s for s in registry.get_shapes(arch) if s.name == shape_name)
    par = make_parallel_config(arch, shape_name)
    tcfg = make_train_config(arch, spec)
    pol = dict(ARCH_POLICY[arch])
    if policy_overrides:
        pol.update(policy_overrides)
        par = ParallelConfig(**{**par.__dict__, **{
            k: v for k, v in policy_overrides.items()
            if k in ParallelConfig.__dataclass_fields__}})
    rules = make_rules(fsdp=par.fsdp, seq_shard_decode=par.seq_shard_decode)
    model = make_model(cfg, par, device="meta", mesh=mesh, rules=rules)

    n_params = count_params(make_model(cfg, device="meta").param_spec())
    n_active = active_param_count(cfg, n_params)

    if spec.kind == "train":
        cell = _train_cell(arch, cfg, spec, tcfg, par, model, mesh, rules,
                           n_params, n_active, pol)
    elif spec.kind == "prefill":
        cell = _prefill_cell(arch, cfg, spec, model, mesh, rules,
                             n_params, n_active)
    else:
        cell = _decode_cell(arch, cfg, spec, model, mesh, rules,
                            n_params, n_active)
    if not abstract:
        cell.args = materialize(cell, cell.args, mesh.devices.flat[0])
    return cell


def _flat(tree: dict) -> dict:
    """A nested parameter-shaped dict flattened to the model's parameter
    names (``"blocks.0.attn.wq"``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": x for n, x in _flat(v).items()})
        else:
            out[k] = v
    return out


@contextlib.contextmanager
def _bound(model, params: dict, grad: bool = False):
    """Inside the block the model's parameters are ``params``' tensors
    (their storage, not a copy; with ``grad``, leaves that take gradients:
    detached views of them); after it, its own again.  Yields the bound
    tensors by parameter name."""
    flat = _flat(params)
    names = [n for n, _ in model.named_parameters()]
    if set(flat) != set(names):
        raise ValueError(f"parameter tree differs from the model's: "
                         f"{sorted(set(flat) ^ set(names))[:4]}")
    saved, bound = {}, {}
    try:
        for n in names:
            mod, key = slot(model, n)
            saved[n] = mod._parameters[key]
            t = flat[n]
            bound[n] = mod._parameters[key] = \
                t.detach().requires_grad_() if grad else t
        yield bound
    finally:
        for n, p in saved.items():
            mod, key = slot(model, n)
            mod._parameters[key] = p


def _forward(model, cfg: ModelConfig, batch: dict):
    if cfg.family == "encdec":
        return model.apply(batch["tokens"], batch["frames"])
    if cfg.family == "vlm":
        return model.apply(positions=batch["positions"],
                           embeds=batch["embeds"])
    return model.apply(batch["tokens"])


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` by a tensor (torch's CUDA kernel multiplies by a Python
    scalar's reciprocal)."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


# ------------------------------------------------------------ train


def _model_inputs(cfg: ModelConfig, spec: ShapeSpec, mesh, for_train: bool):
    """ShapeDtypeStructs for the forward inputs of this family."""
    B, S = spec.global_batch, spec.seq_len
    ba = batch_axes(mesh, B)
    tok_sh = _sh(mesh, ba, None)
    if cfg.family == "encdec":
        # stub audio frontend: encoder frames are precomputed embeddings
        dec_S = min(S, 4096)
        return {
            "tokens": _struct((B, dec_S), torch.int32, tok_sh),
            "frames": _struct((B, S, cfg.d_model), torch.bfloat16,
                              _sh(mesh, ba, None, None)),
        }
    if cfg.family == "vlm":
        return {
            "embeds": _struct((B, S, cfg.d_model), torch.bfloat16,
                              _sh(mesh, ba, None, None)),
            "positions": _struct((B, S, 3), torch.int32,
                                 _sh(mesh, ba, None, None)),
        }
    return {"tokens": _struct((B, S), torch.int32, tok_sh)}


def _labels_spec(cfg: ModelConfig, spec: ShapeSpec, mesh):
    B, S = spec.global_batch, spec.seq_len
    if cfg.family == "encdec":
        S = min(S, 4096)
    ba = batch_axes(mesh, B)
    return _struct((B, S), torch.int32, _sh(mesh, ba, None))


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[B, S] float32 ``logsumexp(logits) - logits[label]``."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  chunk: int = 1024) -> torch.Tensor:
    """Sequence-chunked CE: bounds the fp32 softmax temporaries to
    [B, chunk, V] instead of materializing an fp32 copy of the full logits.
    Sequences no longer than ``chunk``, or not a multiple of it, take the
    mean over the whole [B, S] at once, as the reference does, and so does
    every sequence under ``flags.ROOFLINE_MODE``."""
    B, S, _ = logits.shape
    if flags.ROOFLINE_MODE or S % chunk or S <= chunk:
        return _token_nll(logits, labels).mean()
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(0, S, chunk):
        total = total + _token_nll(logits[:, i:i + chunk],
                                   labels[:, i:i + chunk]).sum()
    return _div(total, B * S)


def cross_entropy_tp(logits: torch.Tensor, labels: torch.Tensor,
                     vocab_size: int, chunk: int = 1024) -> torch.Tensor:
    """:func:`cross_entropy` of a vocabulary-parallel rank: ``logits`` [B,
    S, V_local] are this rank's columns ``[r * V_local, (r + 1) *
    V_local)`` (r its index along ``model``); columns past ``vocab_size``
    (the padding, on the last ranks) are masked out.  Per chunk the row
    maxima meet in a pmax over ``model`` (no gradient), the exp-sums and
    the gold logits (only the rank that owns a label has it) in one psum;
    the same chunking as :func:`cross_entropy`."""
    B, S, n = logits.shape
    col0 = spmd.axis_index("model") * n
    cols = torch.arange(n, device=logits.device) + col0
    pad = cols >= vocab_size

    def nll(lg, lb):
        lf = lg.float().masked_fill(pad, float("-inf"))
        m = spmd.pmax(lf.amax(-1).detach(), "model")
        e = torch.exp(lf - m[..., None]).sum(-1)
        ids = lb.long() - col0
        mine = (ids >= 0) & (ids < n)
        gold = torch.gather(lf, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
        gold = torch.where(mine, gold, torch.zeros((), device=gold.device))
        tot = spmd.psum(torch.stack([e, gold]), "model")
        return torch.log(tot[0]) + m - tot[1]

    if flags.ROOFLINE_MODE or S % chunk or S <= chunk:
        return nll(logits, labels).mean()
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(0, S, chunk):
        total = total + nll(logits[:, i:i + chunk],
                            labels[:, i:i + chunk]).sum()
    return _div(total, B * S)


def model_loss(model, cfg: ModelConfig, logits: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """The next-token cross entropy over the real vocabulary of the model's
    logits: :func:`cross_entropy_tp` on a tensor-parallel rank's block,
    else :func:`cross_entropy` of the logits cut to the vocabulary."""
    if getattr(model, "in_tp_rank", lambda: False)():
        return cross_entropy_tp(logits, labels, cfg.vocab_size)
    return cross_entropy(logits[..., :cfg.vocab_size], labels)


def tp_axes_of(specs: dict) -> dict:
    """Parameter name -> the mesh axes its block is sharded over (what
    ``adamw_update``'s global norm psums over)."""
    return {k: tuple(sorted(spec_axes(v))) for k, v in specs.items()}


def _recast(tree: dict, dtype: torch.dtype) -> dict:
    return {k: _recast(v, dtype) if isinstance(v, dict)
            else _struct(v.shape, dtype, v.sharding) for k, v in tree.items()}


def _train_cell(arch, cfg, spec, tcfg, par, model, mesh, rules,
                n_params, n_active, pol=None) -> Cell:
    p_abs = model.abstract_params()
    # ZeRO-1: optimizer states shard their 'embed'/'expert_mlp' axes over the
    # data axes even when weights are replicated there (policy zero1=True),
    # and always over 'pod' on the multi-pod mesh.
    opt_rules = dict(rules)
    zero_axes = ["pod"] if "pod" in mesh.shape else []
    if (pol or {}).get("zero1"):
        zero_axes.append("data")
    for ax_name in zero_axes:
        for ax in ("embed", "expert_mlp"):
            cur = opt_rules.get(ax) or ()
            if ax_name not in cur:
                opt_rules[ax] = tuple(cur) + (ax_name,)

    sdtype = getattr(torch, tcfg.opt_state_dtype)
    opt_abs_f32 = abstract_tree(model.param_spec(), opt_rules, mesh)
    opt_abs = OptState(
        step=_struct((), torch.int32),
        m=_recast(opt_abs_f32, sdtype),
        v=_recast(opt_abs_f32, sdtype),
        master=_recast(opt_abs_f32, torch.float32) if tcfg.master_weights
        else None)
    inputs = _model_inputs(cfg, spec, mesh, for_train=True)
    labels = _labels_spec(cfg, spec, mesh)

    accum = (pol or ARCH_POLICY[arch]).get("accum", 1)
    B = spec.global_batch
    while accum > 1 and (B % accum or (B // accum) %
                         max(mesh.shape.get("data", 1) *
                             mesh.shape.get("pod", 1), 1)):
        accum //= 2   # keep microbatches shardable over the data axes

    def loss_fn(mb):
        logits, aux = _forward(model, cfg, mb)
        return model_loss(model, cfg, logits, mb["labels"]) + aux

    partitioned = getattr(model, "partitioned", False)
    specs = model.param_specs() if partitioned else None
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)

    # accumulate in bf16 when the optimizer state is bf16 (>=300B models):
    # an fp32 accumulator for 1T params costs 16 GiB/chip by itself.
    acc_dtype = torch.bfloat16 if tcfg.opt_state_dtype == "bfloat16" \
        else torch.float32

    def grads_of(named, mb):
        loss = loss_fn(mb)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(named, gs))

    def train_step(params, opt, batch):
        with _bound(model, params, grad=True) as named:
            if accum > 1:
                # gradient accumulation: microbatch the batch to bound
                # live activations (the big-model policy)
                n = next(iter(batch.values())).shape[0] // accum
                loss = torch.zeros((), dtype=torch.float32,
                                   device=batch["labels"].device)
                grads = {k: torch.zeros(p.shape, dtype=acc_dtype,
                                        device=p.device)
                         for k, p in named.items()}
                for i in range(accum):
                    mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                    li, gs = grads_of(named, mb)
                    for k, g in gs.items():
                        grads[k] += g.to(acc_dtype)
                    loss = loss + li
                    del gs
                loss = _div(loss, accum)
                grads = {k: _div(g, accum) for k, g in grads.items()}
            else:
                loss, grads = grads_of(named, batch)
            axes_of = None
            if partitioned:
                with torch.no_grad():
                    grads = sync_grads_tp(grads, specs, data_axes)
                    loss = spmd.pmean(loss, data_axes)
                axes_of = tp_axes_of(specs)
            flat = OptState(opt.step, _flat(opt.m), _flat(opt.v),
                            None if opt.master is None else
                            _flat(opt.master))
            new, metrics = adamw_update(named, grads, flat, tcfg, axes_of)
            del grads
        metrics["loss"] = loss
        return params, opt._replace(step=new.step), metrics

    batch = dict(inputs, labels=labels)
    return Cell(arch=arch, shape=spec, fn=train_step,
                args=(p_abs, opt_abs, batch), donate=(0, 1),
                model_params=n_params, active_params=n_active,
                model=model, batch_args=(2,), accum=accum,
                partitioned=partitioned)


# ------------------------------------------------------------ prefill


def _prefill_cell(arch, cfg, spec, model, mesh, rules, n_params, n_active
                  ) -> Cell:
    p_abs = model.abstract_params()
    inputs = _model_inputs(cfg, spec, mesh, for_train=False)

    def prefill_step(params, batch):
        with torch.no_grad(), _bound(model, params):
            logits, _ = _forward(model, cfg, batch)
            # a copy of the last position, so that the [B, S, V] logits
            # are freed on return (on a partitioned rank: its block of
            # the vocabulary; the caller cuts the real vocabulary)
            return logits[:, -1].clone()

    return Cell(arch=arch, shape=spec, fn=prefill_step, args=(p_abs, inputs),
                donate=(), model_params=n_params, active_params=n_active,
                model=model, batch_args=(1,),
                partitioned=getattr(model, "partitioned", False))


# ------------------------------------------------------------ decode


def _abstract_cache(model, cfg, spec, mesh, shape_name, rules):
    """ShapeDtypeStructs for the decode cache with per-shape shardings: the
    reference's per-leaf rules, less its stacked layer axis."""
    B, S = spec.global_batch, spec.seq_len
    ba = batch_axes(mesh, B)
    kv_axes = _kv_seq_axes(mesh, shape_name, ba)

    def like(t, *parts):
        return _struct(t.shape, t.dtype, _sh(mesh, *parts))

    if cfg.family == "encdec":
        enc = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
        real = model.init_cache(enc, S)
        return EncDecCache(
            [KVCache(*(like(t, ba, None, kv_axes, None) for t in kv))
             for kv in real.self_kv],                 # self kv [B,H,S,hd]
            [like(t, ba, None, "model", None)         # cross [B,Senc,H,hd]
             for t in real.cross_k],
            [like(t, ba, None, "model", None) for t in real.cross_v])

    # LM families: take structure from init_cache, attach shardings.
    out = []
    for c in model.init_cache(B, S):
        if isinstance(c, KVCache):                    # gqa kv [B,Hkv,S,hd]
            out.append(KVCache(*(like(t, ba, None, kv_axes, None)
                                 for t in c)))
        elif isinstance(c, SSMCache):                 # conv ring [B,K-1,C]
            out.append(SSMCache(                      # state [B,H,hd,N]
                conv=like(c.conv, ba, None, None),
                state=like(c.state, ba, "model", None, None)))
        else:                                         # mla latent [B,S,r]
            out.append(MLACache(*(like(t, ba, kv_axes, None) for t in c)))
    return out


def _decode_cell(arch, cfg, spec, model, mesh, rules, n_params, n_active
                 ) -> Cell:
    B = spec.global_batch
    p_abs = model.abstract_params()
    ba = batch_axes(mesh, B)
    tokens = _struct((B, 1), torch.int32, _sh(mesh, ba, None))
    pos = _struct((B,), torch.int32, _sh(mesh, ba))
    cache = _abstract_cache(model, cfg, spec, mesh, spec.name, rules)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad(), _bound(model, params):
            return model.decode_step(cache, tokens, pos)

    return Cell(arch=arch, shape=spec, fn=serve_step,
                args=(p_abs, cache, tokens, pos), donate=(1,),
                model_params=n_params, active_params=n_active,
                model=model, batch_args=(1, 2, 3))


# ------------------------------------------------------------ values


def _is_struct(x) -> bool:
    return isinstance(x, ShapeDtypeStruct)


def materialize(cell: Cell, args: tuple, device, seed: int = 0) -> tuple:
    """Tensors on ``device`` for ``args`` (the cell's abstract args, or one
    rank's share of them): parameters drawn by the reference's
    initializers from a generator seeded with ``seed``, zero optimizer
    moments and step, float32 master copies of the parameters, token
    batches drawn uniformly from the vocabulary, stub frames and patch
    embeddings N(0, 1) in bf16, positions ``arange`` (t = h = w for
    M-RoPE), zero decode caches and positions.  On the meta device every
    leaf is an empty meta tensor."""
    dev = torch.device(device)
    if dev.type == "meta":
        return pytree.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=dev)
            if _is_struct(s) else s, args)
    cfg = cell.model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)

    def empty(s):
        return torch.empty(s.shape, dtype=s.dtype, device=dev)

    def zeros(s):
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    params = {}
    for path, spec in tree_leaves_with_path(cell.model.param_spec()):
        t = empty(_leaf(args[0], path))
        init_leaf(t, spec, g)
        params[path] = t
    p = unflatten(params)

    def batch_of(tree):
        out = {}
        for k, s in tree.items():
            if k in ("tokens", "labels"):
                out[k] = torch.randint(0, cfg.vocab_size, s.shape,
                                       generator=g, device=dev,
                                       dtype=s.dtype)
            elif k == "positions":
                ar = torch.arange(s.shape[1], dtype=s.dtype, device=dev)
                out[k] = ar[None, :, None].expand(s.shape).contiguous()
            else:
                out[k] = torch.randn(s.shape, generator=g, device=dev
                                     ).to(s.dtype)
        return out

    kind = cell.shape.kind
    if kind == "train":
        _, opt, batch = args
        master = None if opt.master is None else unflatten({
            path: x.float() for path, x in params.items()})
        o = OptState(zeros(opt.step), pytree.tree_map(zeros, opt.m),
                     pytree.tree_map(zeros, opt.v), master)
        return p, o, batch_of(batch)
    if kind == "prefill":
        return p, batch_of(args[1])
    _, cache, tokens, pos = args
    return (p, pytree.tree_map(zeros, cache),
            torch.randint(0, cfg.vocab_size, tokens.shape, generator=g,
                          device=dev, dtype=tokens.dtype), zeros(pos))


def _leaf(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree
