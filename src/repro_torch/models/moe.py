"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch.

The port of ``repro/models/moe.py``.  The reference's dispatch is XLA
sort, scatter and gather plus ``einsum`` products, no Pallas kernel, so it
stays plain torch here; the expert products are ``torch.bmm``.  Without a
mesh it runs the reference's ``ep=1, has_a2a=False`` path.  Under a mesh
(``moe_block``'s ``mesh``) it runs the reference's expert-parallel path
under :func:`~repro_torch.parallel.spmd.shard_map`, manual over every axis:
the batch split over the data axes that divide it and the sequence over
``model`` when it divides, the experts split over ``model``; each rank
routes its own tokens, buckets them by destination rank into ``[ep,
C_send, d]`` send buffers, exchanges them with ``all_to_all`` over
``model``, runs its ``E / ep`` experts, returns the rows with a second
``all_to_all`` and combines them at the source; the aux loss is
``pmean``-ed over the mesh.  A rank of a partitioned model (the
tensor-parallel program of ``models/lm.py``, manual over ``model``) runs
that body, :func:`moe_rank`, on its own tokens: the ``all_to_all``s are
differentiable copies (``parallel/spmd.py``), so the trainer's one
backward runs through them, and under remat only the rank-local segments
between the exchanges are recomputed.  Inside a rank of the trainer's
data-parallel ``shard_map`` (whole experts) the rank's tokens take the
one-device path.

Which assignments a full capacity drops depends on their order, so the
port keeps the reference's exactly:

- top-k is a stable descending sort of the router's probabilities: the k
  largest in descending order, the lower expert index first on a tie
  (``jax.lax.top_k``);
- the flat assignments are token-major, then gate order
  (``jnp.repeat(jnp.arange(T), k)``);
- ranks within a bucket come from a stable argsort (:func:`_rank_in_bucket`).

With one device every assignment goes to one send bucket, so its rank is
its flat position and the send buffer is the first ``C_send`` flat rows.
Buffers are written by index at unique slots; a dropped row goes to one
extra slot past the end, which is cut off (the reference adds zeros at its
spill slot instead: the same values, and no host sync for a mask here).
The combine adds each token's k weighted rows one after another in the
activation dtype, as XLA's scatter-add does, in a fixed order on every
device (no float atomics).

dtypes: the router and its softmax are float32; routed experts keep the
activation dtype (bf16), SiLU included; the shared expert's SiLU goes
through float32; gates are cast to the activation dtype before the
multiply.  ``jax.nn.gelu`` is the tanh approximation.  The auxiliary loss
``E * coef * sum(mean(probs) * counts / (T k))`` carries its gradient
through the probabilities only.

Long inputs are dispatched in ``DISPATCH_CHUNK``-token chunks (one chunk
when the token count is not a multiple, or all tokens in one under
``flags.ROOFLINE_MODE``); their aux losses are summed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import flags
from ..config import ModelConfig
from torch.utils.checkpoint import checkpoint

from ..parallel.spmd import (P, all_to_all, axis_size, in_rank, manual_axes,
                             pmean, shard_map)
from .params import ParamSpec

__all__ = ["DISPATCH_CHUNK", "moe_spec", "moe_block", "moe_rank", "top_k",
           "capacities", "ep_slots"]

DISPATCH_CHUNK = 8192   # tokens per dispatch round (bounds buffer memory)


def moe_spec(cfg: ModelConfig, layers: int | None = None) -> dict:
    """One layer's experts; ``layers`` is the reference's stacked axis."""
    m, d, st = cfg.moe, cfg.d_model, layers or 1
    n_in = 2 if cfg.activation == "swiglu" else 1
    spec = {
        "router": ParamSpec((d, m.num_experts), ("embed", "experts"),
                            init="normal", scale=0.02, dtype=torch.float32,
                            stack=st),
        "wi": ParamSpec((m.num_experts, d, n_in, m.d_ff_expert),
                        ("experts", "embed", None, "expert_mlp"), stack=st),
        "wo": ParamSpec((m.num_experts, m.d_ff_expert, d),
                        ("experts", "expert_mlp", "embed"), stack=st),
    }
    if m.shared_expert_d_ff:
        spec["shared_wi"] = ParamSpec((d, n_in, m.shared_expert_d_ff),
                                      ("embed", None, "mlp"), stack=st)
        spec["shared_wo"] = ParamSpec((m.shared_expert_d_ff, d),
                                      ("mlp", "embed"), stack=st)
    return spec


def _expert_ffn(wi, wo, x, activation: str) -> torch.Tensor:
    """x: [E, C, d] -> [E, C, d], in the input dtype throughout (the
    reference's SiLU is ``x * sigmoid(x)``, each op rounded)."""
    E, d = wi.shape[0], wi.shape[1]
    h = torch.bmm(x, wi.reshape(E, d, -1)).unflatten(-1, wi.shape[2:])
    if activation == "swiglu":
        g, u = h[..., 0, :], h[..., 1, :]
        a = g * torch.sigmoid(g) * u
    elif activation == "relu2":
        a = torch.square(torch.relu(h[..., 0, :]))
    else:
        a = F.gelu(h[..., 0, :], approximate="tanh")
    return torch.bmm(a, wo)


def _rank_in_bucket(bucket_ids: torch.Tensor, n_buckets: int
                    ) -> torch.Tensor:
    """rank[i] = #(j < i with bucket_ids[j] == bucket_ids[i]), by a stable
    sort."""
    n = bucket_ids.shape[0]
    order = torch.argsort(bucket_ids, stable=True)
    sorted_b = bucket_ids[order]
    start = torch.searchsorted(sorted_b, torch.arange(
        n_buckets, dtype=sorted_b.dtype, device=sorted_b.device))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device) - start[sorted_b]
    return rank


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest of each row in descending order,
    the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacities(cfg: ModelConfig, T: int) -> tuple[int, int]:
    """``(C_send, C_loc)`` of one dispatch chunk of ``T`` tokens on one
    device: the send buffer's rows, and each expert's."""
    m = cfg.moe
    E = m.num_experts
    c_send = int(math.ceil(T * m.experts_per_token * m.capacity_factor))
    c_loc = int(math.ceil(c_send / E * m.capacity_factor)) if E > 1 \
        else c_send
    return c_send, c_loc


def _route(xt, router, cfg):
    """Router probabilities [T, E], normalized gates and expert ids [T, k]
    and the chunk's aux loss."""
    m = cfg.moe
    T, k, E = xt.shape[0], m.experts_per_token, m.num_experts
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(0)
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device)
    counts.scatter_add_(0, expert_idx.reshape(-1),
                        torch.ones_like(expert_idx.reshape(-1)))
    ce = counts.float() / (T * k)
    aux = (me * ce).sum() * E * m.aux_loss_coef
    return gate_vals, expert_idx, aux


def _slots(flat_e: torch.Tensor, cfg: ModelConfig, T: int):
    """Where the send buffer's rows land: ``(ekeep [C_send], slot
    [C_send])`` — kept at their expert, and their row of the flat
    ``[E * C_loc]`` expert buffer (``E * C_loc`` for rows that are empty or
    dropped).  The send buffer holds the first ``C_send`` of the ``T * k``
    flat assignments (expert ids token-major): with one device they all go
    to one bucket, where each one's rank is its flat position."""
    E = cfg.moe.num_experts
    c_send, c_loc = capacities(cfg, T)
    m = min(flat_e.shape[0], c_send)
    re = torch.full((c_send,), E, dtype=flat_e.dtype, device=flat_e.device)
    re[:m] = flat_e[:m]
    er = _rank_in_bucket(re, E + 1)
    ekeep = (re < E) & (er < c_loc)
    return ekeep, torch.where(ekeep, re * c_loc + er, E * c_loc)


def _moe_chunk(xt, router, wi, wo, cfg: ModelConfig):
    """One dispatch chunk.  xt: [T, d].  Returns (y [T, d], aux)."""
    m = cfg.moe
    T, d = xt.shape
    k, E = m.experts_per_token, m.num_experts
    c_send, c_loc = capacities(cfg, T)
    gate_vals, expert_idx, aux = _route(xt, router, cfg)
    flat_e = expert_idx.reshape(-1)
    src_tok = torch.arange(T, device=xt.device).repeat_interleave(k)
    ekeep, slot = _slots(flat_e, cfg, T)
    # the send buffer is the first C_send flat rows (zeros past T*k)
    m_ = min(T * k, c_send)
    rx = xt.new_zeros((c_send, d))
    rx[:m_] = xt[src_tok[:m_]]
    buf = xt.new_zeros((E * c_loc + 1, d))
    buf[slot] = rx
    out = _expert_ffn(wi, wo, buf[:-1].view(E, c_loc, d), cfg.activation)
    back = torch.where(ekeep[:, None],
                       out.reshape(E * c_loc, d)[slot.clamp_max(
                           E * c_loc - 1)], 0)
    gathered = xt.new_zeros((T * k, d))
    gathered[:m_] = back[:m_]
    w = gate_vals.reshape(-1, 1).to(xt.dtype)
    rows = (gathered * w).view(T, k, d)
    y = rows[:, 0]
    for j in range(1, k):            # XLA's scatter-add order, rounded
        y = y + rows[:, j]
    return y, aux


def ep_slots(bucket: torch.Tensor, n_buckets: int, cap: int,
             valid: torch.Tensor | None = None):
    """Where the rows of a bucketed buffer go: ``(keep, slot)``.  A row's
    rank in its bucket comes from a stable argsort; rows of rank below
    ``cap`` (and ``valid``) keep slot ``bucket * cap + rank``, the others
    go to the spill slot ``n_buckets * cap``, which is cut off."""
    rank = _rank_in_bucket(bucket, n_buckets)
    keep = rank < cap
    if valid is not None:
        keep = keep & valid
    return keep, torch.where(keep, bucket * cap + rank, n_buckets * cap)


def _ep_send(xt, router, cfg: ModelConfig, ep: int):
    """Route a chunk of ``T`` tokens and bucket its ``T * k`` rows by the
    expert-parallel rank that holds their expert: ``(send_x [ep, C_send,
    d], send_e [ep, C_send] (the expert's index on that rank, -1 for an
    empty row), keep, slot, gates [T, k], aux)``, ``C_send`` from ``T``."""
    m = cfg.moe
    T, d = xt.shape
    k, e_loc = m.experts_per_token, m.num_experts // ep
    gate_vals, expert_idx, aux = _route(xt, router, cfg)
    flat_e = expert_idx.reshape(-1)
    src_tok = torch.arange(T, device=xt.device).repeat_interleave(k)
    c_send = int(math.ceil(T * k / ep * m.capacity_factor))
    n_send = ep * c_send
    keep, sslot = ep_slots(flat_e // e_loc, ep, c_send)
    send_x = xt.new_zeros((n_send + 1, d))
    send_x[sslot] = xt[src_tok]
    send_e = torch.full((n_send + 1,), -1, dtype=flat_e.dtype,
                        device=xt.device)
    send_e[sslot] = flat_e % e_loc
    return (send_x[:-1].view(ep, c_send, d), send_e[:-1].view(ep, c_send),
            keep, sslot, gate_vals, aux)


def _ep_experts(rx, re, wi, wo, cfg: ModelConfig, ep: int):
    """The rank's ``E / ep`` experts (``wi``/``wo``) on the rows it
    received, ``rx`` [ep, C_send, d] with expert ids ``re``: the results
    in the same places (zeros where a row was empty or dropped)."""
    m = cfg.moe
    _, c_send, d = rx.shape
    e_loc, n_send = m.num_experts // ep, ep * c_send
    rx, re = rx.reshape(n_send, d), re.reshape(n_send)
    # C_send already carries the capacity slack; the local buffer only
    # needs mild imbalance headroom across the rank's experts.  Empty rows
    # (re = -1) rank in a spare bucket e_loc and are never kept.
    c_loc = int(math.ceil(n_send / max(e_loc, 1) * m.capacity_factor)) \
        if e_loc > 1 else n_send
    ekeep, eslot = ep_slots(torch.where(re >= 0, re, e_loc), e_loc + 1,
                            c_loc, re >= 0)
    n_exp = e_loc * c_loc
    buf = rx.new_zeros(((e_loc + 1) * c_loc + 1, d))
    buf[eslot] = rx
    out = _expert_ffn(wi, wo, buf[:n_exp].view(e_loc, c_loc, d),
                      cfg.activation)
    back = torch.where(ekeep[:, None], out.reshape(n_exp, d)[
        eslot.clamp_max(n_exp - 1)], 0)
    return back.view(ep, c_send, d)


def _ep_combine(back, keep, sslot, gate_vals):
    """Each token's k returned rows ``back`` [ep, C_send, d] weighted by
    its gates and added in gate order: y [T, d]."""
    ep, c_send, d = back.shape
    n_send = ep * c_send
    T, k = gate_vals.shape
    gathered = torch.where(keep[:, None], back.reshape(n_send, d)[
        sslot.clamp_max(n_send - 1)], 0)
    w = gate_vals.reshape(-1, 1).to(back.dtype)
    rows = (gathered * w).view(T, k, d)
    y = rows[:, 0]
    for j in range(1, k):            # XLA's scatter-add order, rounded
        y = y + rows[:, j]
    return y


def _chunk(T: int) -> int:
    """Tokens a dispatch round: ``DISPATCH_CHUNK`` (all ``T`` under
    ``flags.ROOFLINE_MODE``, or when it does not divide ``T``)."""
    chunk = T if flags.ROOFLINE_MODE else min(DISPATCH_CHUNK, T)
    return T if T % chunk else chunk


def moe_rank(param, x: torch.Tensor, cfg: ModelConfig, norm=None,
             remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` body (``moe.py:179-183``) on one rank
    of a partitioned model, inside a rank manual over ``model``: the
    routed experts' output for the rank's tokens ``x`` [B, S, d] and the
    aux loss ``pmean``-ed over every manual axis.  ``param(name)`` gives
    the rank's ``router`` whole and its ``E / ep`` experts ``wi``/``wo``
    (ep the ``model`` axis's size); ``norm`` (``ln2``) is applied to ``x``
    first.  Each chunk of ``DISPATCH_CHUNK`` tokens is routed and bucketed
    (``C_send`` from the chunk's own tokens), exchanged with
    ``all_to_all`` over ``model``, run through the rank's experts,
    returned and combined.  With ``remat`` (and gradients on) the three
    rank-local segments around the exchanges (norm -> router -> buckets;
    the experts; the combine) run under ``torch.utils.checkpoint``, and
    ``param`` is called inside them, so no recompute calls a collective
    and FSDP's gathers run again there."""
    B, S, d = x.shape
    ep = axis_size("model")
    manual = tuple(a for a in ("pod", "data", "model")
                   if a in manual_axes())
    remat = remat and torch.is_grad_enabled()

    if not remat:       # one gather a layer; remat gathers a segment
        held = {k: param(k) for k in ("router", "wi", "wo")}
        param = held.__getitem__

    def run(f, *args):
        return checkpoint(f, *args, use_reentrant=False) if remat \
            else f(*args)

    def send(xc):
        h = xc if norm is None else norm(xc)
        return _ep_send(h, param("router"), cfg, ep)

    def experts(rx, re):
        return _ep_experts(rx, re, param("wi"), param("wo"), cfg, ep)

    xt = x.reshape(-1, d)
    T = xt.shape[0]
    chunk = _chunk(T)
    ys, auxs = [], []
    for i in range(0, T, chunk):
        send_x, send_e, keep, sslot, gates, aux = run(send,
                                                      xt[i:i + chunk])
        back = run(experts, all_to_all(send_x, "model", 0, 0),
                   all_to_all(send_e, "model", 0, 0))
        ys.append(run(_ep_combine, all_to_all(back, "model", 0, 0), keep,
                      sslot, gates))
        auxs.append(aux)
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    aux = auxs[0] if len(auxs) == 1 else torch.stack(auxs).sum()
    return y.reshape(B, S, d), pmean(aux, manual)


def _moe_tokens(xt, router, wi, wo, cfg: ModelConfig):
    """Chunked one-device dispatch over the token axis."""
    T, d = xt.shape
    chunk = _chunk(T)
    if chunk == T:
        return _moe_chunk(xt, router, wi, wo, cfg)
    ys, auxs = zip(*(_moe_chunk(xt[i:i + chunk], router, wi, wo, cfg)
                     for i in range(0, T, chunk)))
    return torch.cat(ys), torch.stack(auxs).sum()


def _moe_mesh(p, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The reference's mesh branch (``moe.py:151-191``): (y, aux)."""
    B, S, d = x.shape
    manual = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    # shard the batch over whatever data axes divide it (long-context
    # decode has B=1: tokens then replicate over data, a2a still over EP)
    batch_ax, nb = [], 1
    for a in ("pod", "data"):
        if a in mesh.shape and B % (nb * mesh.shape[a]) == 0:
            batch_ax.append(a)
            nb *= mesh.shape[a]
    batch_ax = tuple(batch_ax) or None
    ep = mesh.shape.get("model", 1)
    # tokens also split over the EP axis (sequence split), else every EP
    # rank would route the same tokens; decode steps (S == 1) replicate
    seq_ax = "model" if S % max(ep, 1) == 0 and S >= ep else None

    def local(xl, router, wi_loc, wo_loc):
        if ep > 1:
            p_loc = {"router": router, "wi": wi_loc, "wo": wo_loc}
            return moe_rank(p_loc.__getitem__, xl, cfg)
        bl, sl = xl.shape[0], xl.shape[1]
        y, aux = _moe_tokens(xl.reshape(bl * sl, d), router, wi_loc, wo_loc,
                             cfg)
        return y.reshape(bl, sl, d), pmean(aux, manual)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(batch_ax, seq_ax, None), P(), P("model"),
                             P("model")),
                   out_specs=(P(batch_ax, seq_ax, None), P()))
    return fn(x, p["router"], p["wi"], p["wo"])


def moe_block(p, x: torch.Tensor, cfg: ModelConfig, rules=None, mesh=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d].  Returns (y [B, S, d], aux loss).  ``mesh`` (the
    reference's argument, as ``rules``, which the dispatch does not read)
    runs the expert-parallel path; a mesh of one device the one-device
    path.  Inside a ``shard_map`` rank: a rank of a partitioned model
    (manual over a ``model`` axis larger than 1, ``p`` holding the router
    whole and the rank's ``E / ep`` experts) runs the reference's
    ``shard_map`` body (:func:`moe_rank`) on its tokens ``x``; any other
    rank (whole experts: a model that is not partitioned) the one-device
    path.  A partitioned rank's shared expert is column-parallel over
    ``model``; ``LM._apply_tp`` adds it, and this function refuses it."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    if _partitioned_rank(p, cfg):
        if cfg.moe.shared_expert_d_ff:
            raise ValueError("a partitioned rank's shared expert is "
                             "column-parallel: LM._apply_tp adds it")
        return moe_rank(p.__getitem__, x, cfg)
    if mesh is None or mesh.size == 1 or in_rank():
        y, aux = _moe_tokens(xt, p["router"], p["wi"], p["wo"], cfg)
        y = y.reshape(B, S, d)
    else:
        y, aux = _moe_mesh(p, x, cfg, mesh)
    if cfg.moe.shared_expert_d_ff:
        y = y + shared_expert(p["shared_wi"], p["shared_wo"], xt,
                              cfg).reshape(B, S, d)
    return y, aux


def _partitioned_rank(p, cfg: ModelConfig) -> bool:
    """Whether the caller is a rank manual over a ``model`` axis larger
    than 1 that holds a block of the experts."""
    return "model" in manual_axes() and axis_size("model") > 1 and \
        p["wi"].shape[0] < cfg.moe.num_experts


def shared_expert(wi, wo, xt: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """The shared expert on ``xt`` [T, d] (or a rank's column block of it:
    ``wi`` [d, n_in, f_loc], ``wo`` [f_loc, d] give the rank's partial
    product)."""
    d = xt.shape[-1]
    h = (xt @ wi.reshape(d, -1)).unflatten(-1, wi.shape[1:])
    if cfg.activation == "swiglu":
        a = F.silu(h[..., 0, :].float()).to(xt.dtype) * h[..., 1, :]
    else:
        a = F.gelu(h[..., 0, :], approximate="tanh")
    return a @ wo
