"""AdamW with cosine schedule, global-norm clipping, and mixed-precision
optimizer state (bf16 m/v for >=300B models — halves optimizer memory).

The port of ``repro/optim/adamw.py``.  Trees are dicts of tensors keyed by
the model's parameter names (``dict(model.named_parameters())``).
:func:`adamw_update` keeps the reference's arithmetic (float32 throughout,
the fp32 master copy when kept, weight decay on every leaf, bias correction
from the incremented step, ``lr = 0`` at step 0) but writes the new values
into the parameters, ``m``, ``v`` and the master copy in place, leaf by
leaf, where the reference returns new trees: at full width a second copy of
the optimizer state would not fit on the card.  Divisions go by tensors on
the parameters' device, never by a Python scalar (torch's CUDA kernel
multiplies by the scalar's reciprocal instead).  It stays plain torch: the
reference computes it outside any kernel of its own.

On a rank of a partitioned program each leaf is the rank's block:
``axes_of`` names, per leaf, the mesh axes it is sharded over, and
:func:`global_norm` psums each such leaf's squared sum over them (a leaf
replicated there counts once), so the clipping scale, and with it every
block's update, is one device's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import TrainConfig
from ..parallel import spmd

__all__ = ["OptState", "cosine_lr", "init_opt_state", "global_norm",
           "adamw_update"]


class OptState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    m: dict
    v: dict
    master: dict | None       # fp32 master weights (optional)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cosine_lr(cfg: TrainConfig):
    """``step`` (an integer tensor) -> the learning rate, a 0-d float32
    tensor on the step's device: linear warmup from 0, then cosine decay to
    0 at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), s),
                             _f32(1.0, s))
        t = torch.clamp((s - cfg.warmup_steps) /
                        _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                        0, 1)
        return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))
    return lr


def init_opt_state(params: dict, cfg: TrainConfig) -> OptState:
    """Zero ``m``/``v`` in ``cfg.opt_state_dtype`` and, with
    ``master_weights``, a float32 copy of every parameter."""
    sdtype = getattr(torch, cfg.opt_state_dtype)
    dev = next(iter(params.values())).device
    master = None
    if cfg.master_weights:
        master = {n: p.detach().float().clone() for n, p in params.items()}
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=sdtype, device=dev)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=sdtype, device=dev)
           for n, p in params.items()},
        master=master)


def global_norm(tree: dict, axes_of: dict | None = None) -> torch.Tensor:
    """The L2 norm of every leaf together.  ``axes_of`` (inside a rank):
    leaf name -> the mesh axes the leaf is sharded over; the squared sums
    of the leaves sharded over the same axes are added, then psummed over
    those axes."""
    groups: dict = {}
    for name, x in tree.items():
        axes = tuple(sorted((axes_of or {}).get(name, ())))
        sq = torch.sum(torch.square(x.float()))
        groups[axes] = sq if axes not in groups else groups[axes] + sq
    total = None
    for axes in sorted(groups):
        sq = spmd.psum(groups[axes], axes) if axes else groups[axes]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState,
                 cfg: TrainConfig, axes_of: dict | None = None
                 ) -> tuple[OptState, dict]:
    """One AdamW step.  ``params`` (the model's parameters), ``state.m``,
    ``state.v`` and ``state.master`` are updated in place; returns (the
    state with its step incremented, metrics {"lr", "grad_norm"}).
    ``axes_of``: as in :func:`global_norm`, on a rank's blocks."""
    lr = cosine_lr(cfg)(state.step)
    gnorm = global_norm(grads, axes_of)
    one = _f32(1.0, gnorm)
    scale = torch.minimum(one, _f32(cfg.grad_clip, gnorm) / torch.maximum(
        gnorm, _f32(1e-9, gnorm))) if cfg.grad_clip else one
    step = state.step + 1
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m32 = b1 * state.m[name].float() + (1 - b1) * g
        v32 = b2 * state.v[name].float() + (1 - b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        base = state.master[name] if state.master is not None \
            else p.float()
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.adam_eps)
                           + cfg.weight_decay * base)
        state.m[name].copy_(m32)
        state.v[name].copy_(v32)
        if state.master is not None:
            state.master[name].copy_(new)
        p.copy_(new)
    return (OptState(step=step, m=state.m, v=state.v, master=state.master),
            {"lr": lr, "grad_norm": gnorm})
