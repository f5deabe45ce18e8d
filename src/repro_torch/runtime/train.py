"""Training runtime: the step (value and gradient of the loss, then AdamW,
on one device or with explicit-ring gradient sync over the data axes of a
mesh), checkpoint/restart fault tolerance, straggler monitor.

The port of ``repro/runtime/train.py``.  Fault model:
  * node failure -> the job restarts from the latest checkpoint; since data
    order is a pure function of (seed, step), training replays the same
    batches after a restart.
  * stragglers -> per-step wall-time EMA + z-score detector.
The model owns its parameters, so a step updates them in place and returns
the optimizer state and metrics.  Without a mesh (or with
``grad_sync="xla"``, where the reference leaves the sync to GSPMD: the same
values as one device) everything runs where the model's parameters lie.
``grad_sync="ring"``/``"hierarchical"`` under a mesh is the reference's
``manual_step``: one model replica and one optimizer state per data rank,
each rank's loss and gradients on its shard of the batch, the gradients
synchronized by the explicit rings (:func:`~repro_torch.collectives.
scheduler.sync_grads_local`), then AdamW on every rank (:class:`RingStep`).
A mesh whose ``model`` axis is larger than 1 gives the tensor-parallel
step (:class:`TPStep`, the dense GQA and MLA, MoE, SSM and hybrid
families; the VLM and the encoder-decoder raise ``NotImplementedError``):
each rank of the whole mesh holds its blocks of the parameters and
optimizer state, and the ranks' forwards form one autograd graph with one
backward (``parallel/spmd.py``), the MoE's ``all_to_all`` exchanges and
its aux loss included.  An SSM layer runs the plain scan on each rank's
heads (the SSD kernel is forward only).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..collectives.scheduler import sync_grads_local, sync_grads_tp
from ..config import ModelConfig, ParallelConfig, TrainConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..launch.steps import model_loss, tp_axes_of
from ..models.model import check_tp, replicate
from ..optim.adamw import OptState, adamw_update, init_opt_state
from ..parallel import spmd
from ..parallel.sharding import gather_shards, shard_tensor
from ..parallel.spmd import P, axis_index, pmean, rank_devices, shard_map

__all__ = ["make_loss_fn", "make_train_step", "RingStep", "TPStep",
           "StragglerMonitor", "TrainerReport", "Trainer",
           "SimulatedFailure"]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_loss_fn(model, cfg: ModelConfig):
    """batch {"tokens", "labels"} ([B, S] integer tensors) -> the mean
    next-token cross entropy over the real vocabulary, plus the model's
    auxiliary loss."""
    def loss_fn(batch):
        logits, aux = model.apply(batch["tokens"])
        return model_loss(model, cfg, logits, batch["labels"]) + aux
    return loss_fn


def make_train_step(model, cfg: ModelConfig, tcfg: TrainConfig,
                    par: ParallelConfig, mesh=None):
    """Returns ``step(opt, batch) -> (opt, metrics)``: the value and
    gradient of the loss over the model's parameters, then
    :func:`~repro_torch.optim.adamw.adamw_update` on them in place.
    ``metrics`` holds 0-d tensors "loss", "lr" and "grad_norm" on the
    model's device.  ``grad_sync="ring"``/``"hierarchical"`` under a mesh
    whose data axes ("pod", "data") have more than one rank returns a
    :class:`RingStep`; a mesh whose ``model`` axis is larger than 1 a
    :class:`TPStep` for the dense GQA and MLA, MoE, SSM and hybrid
    families and ``NotImplementedError`` for the VLM and the
    encoder-decoder (ROADMAP queue 1 item 1, left 6)."""
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return TPStep(model, cfg, tcfg, par, mesh)
    if mesh is not None and par.grad_sync != "xla":
        if par.grad_sync not in ("ring", "hierarchical"):
            raise ValueError(f"unknown grad_sync {par.grad_sync!r}")
        if any(mesh.shape.get(a, 1) > 1 for a in ("pod", "data")):
            return RingStep(model, cfg, tcfg, par, mesh)
    loss_fn = make_loss_fn(model, cfg)
    params = dict(model.named_parameters())

    def step(opt: OptState, batch: dict) -> tuple[OptState, dict]:
        loss = loss_fn(batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        opt, metrics = adamw_update(params, grads, opt, tcfg)
        metrics["loss"] = loss.detach()
        return opt, metrics

    return step


def _opt_on(opt: OptState, dev: torch.device) -> OptState:
    """A copy of ``opt`` on ``dev``."""
    def cp(tree):
        return None if tree is None else \
            {k: v.to(dev, copy=True) for k, v in tree.items()}
    return OptState(opt.step.to(dev, copy=True), cp(opt.m), cp(opt.v),
                    cp(opt.master))


class RingStep:
    """The reference's ``manual_step`` under a mesh: ``step(opt, batch) ->
    (opt, metrics)`` with one model replica (``replicas``) and one optimizer
    state (``opts``) per data rank, rank 0's being the caller's model and
    ``opt``.  Under :func:`~repro_torch.parallel.spmd.shard_map` manual over
    the data axes, each rank takes its shard of the batch (split over the
    data axes), computes its loss and gradients, runs
    ``sync_grads_local(grads, data_axes, mode, channels=par.ring_buckets,
    bidirectional=par.ring_bidirectional)``, ``pmean``s the loss and runs
    AdamW in place.  Every rank applies the same synced gradients to the
    same values, so the replicas stay bit-equal.  An ``opt`` other than the
    one the last step returned (a fresh or restored state of rank 0)
    first copies rank 0's parameters and ``opt`` onto every other rank."""

    def __init__(self, model, cfg: ModelConfig, tcfg: TrainConfig,
                 par: ParallelConfig, mesh):
        self.tcfg, self.par, self.mesh = tcfg, par, mesh
        self.data_axes = tuple(a for a in ("pod", "data")
                               if mesh.shape.get(a, 1) > 1)
        self.mode = par.grad_sync
        devs = rank_devices(mesh, self.data_axes)
        self.replicas = [model] + [replicate(model, d) for d in devs[1:]]
        self.params = [dict(m.named_parameters()) for m in self.replicas]
        self.loss_fns = [make_loss_fn(m, cfg) for m in self.replicas]
        self.opts: list[OptState] | None = None
        spec = P(self.data_axes)
        self.batch_spec = {"tokens": spec, "labels": spec}

    def _grads(self, batch: dict):
        """This rank's (index, pmean-ed loss, synced gradients)."""
        r = axis_index(self.data_axes)
        params = self.params[r]
        loss = self.loss_fns[r](batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        grads = sync_grads_local(grads, self.data_axes, mode=self.mode,
                                 channels=self.par.ring_buckets,
                                 bidirectional=self.par.ring_bidirectional)
        return r, pmean(loss.detach(), self.data_axes), grads

    def grads(self, batch: dict) -> tuple[torch.Tensor, list[dict]]:
        """The first half of a step, nothing updated: (the loss over the
        global batch, each rank's synced gradients)."""
        out: list = [None] * len(self.replicas)

        def local(b):
            r, loss, g = self._grads(b)
            out[r] = g
            return loss

        loss = shard_map(local, mesh=self.mesh, in_specs=(self.batch_spec,),
                         out_specs=P(), axis_names=self.data_axes)(batch)
        return loss, out

    def _broadcast(self, opt: OptState) -> None:
        with torch.no_grad():
            for params in self.params[1:]:
                for name, p in params.items():
                    p.copy_(self.params[0][name])
        self.opts = [opt] + [_opt_on(opt, next(iter(p.values())).device)
                             for p in self.params[1:]]

    def __call__(self, opt: OptState, batch: dict) -> tuple[OptState, dict]:
        if self.opts is None or opt is not self.opts[0]:
            self._broadcast(opt)

        def local(b):
            r, loss, grads = self._grads(b)
            self.opts[r], metrics = adamw_update(self.params[r], grads,
                                                 self.opts[r], self.tcfg)
            metrics["loss"] = loss
            return metrics

        metrics = shard_map(
            local, mesh=self.mesh, in_specs=(self.batch_spec,),
            out_specs={"loss": P(), "lr": P(), "grad_norm": P()},
            axis_names=self.data_axes)(batch)
        return self.opts[0], metrics


class TPStep:
    """The tensor-parallel training step over every axis of ``mesh``:
    ``step(opt, batch) -> (opt, metrics)`` with the model's and ``opt``'s
    semantics of the one-device step (both updated in place).

    The ranks are ``model.tp_ranks()`` (each holding its blocks of the
    parameters) with ``opts``, their blocks of the optimizer state, taken
    from the ``opt`` it is handed whenever that is not the one the last
    step returned or the model's parameters changed since.  A step: under :func:`~repro_torch.parallel.spmd.
    shard_map` manual over every axis each rank runs its forward on its
    data group's share of the batch (split over the data axes) and its
    loss with the MoE aux loss, ``pmean``-ed over the data axes (every rank
    then holds the global loss); one backward from rank 0's copy gives every rank's
    gradients; :func:`~repro_torch.collectives.scheduler.sync_grads_tp`
    sums the replicated leaves over ``model`` and the data axes
    (``grad_sync``: ``"xla"`` a psum, ``"ring"``/``"hierarchical"`` the
    rings over the rank's data group); AdamW updates each rank's blocks
    with the global gradient norm.  Then the blocks are written back into
    the model and ``opt`` (:meth:`~repro_torch.models.lm.LM.gather`);
    :meth:`grads` is the first half alone."""

    def __init__(self, model, cfg: ModelConfig, tcfg: TrainConfig,
                 par: ParallelConfig, mesh):
        if par.grad_sync not in ("xla", "ring", "hierarchical"):
            raise ValueError(f"unknown grad_sync {par.grad_sync!r}")
        check_tp(cfg, mesh, model)
        self.model, self.cfg, self.tcfg, self.par = model, cfg, tcfg, par
        self.mesh = model.mesh
        self.data_axes = tuple(a for a in ("pod", "data")
                               if mesh.shape.get(a, 1) > 1)
        self.specs = model.param_specs()
        self.axes_of = tp_axes_of(self.specs)
        spec = P(self.data_axes or None)
        self.batch_spec = {"tokens": spec, "labels": spec}
        self.ranks: list | None = None
        self.opts: list[OptState] | None = None
        self._opt = None

    def _scatter(self, opt: OptState) -> None:
        """The ranks and their blocks of ``opt``."""
        self.ranks = self.model.tp_ranks()
        mesh, names = self.mesh, list(self.specs)

        def blocks(tree):
            if tree is None:
                return [None] * len(self.ranks)
            per = {k: shard_tensor(tree[k], self.specs[k], mesh)
                   for k in names}
            return [{k: per[k][r] for k in names}
                    for r in range(len(self.ranks))]

        devs = [next(r.parameters()).device for r in self.ranks]
        self.opts = [OptState(opt.step.to(d, copy=True), m, v, w)
                     for d, m, v, w in zip(devs, blocks(opt.m),
                                           blocks(opt.v),
                                           blocks(opt.master))]

    def _join(self) -> None:
        """The caller's stream waits for the ranks' (a backward ran on
        them)."""
        for (_, dev), s in spmd.rank_streams(self.mesh).items():
            torch.cuda.current_stream(dev).wait_stream(s)

    def grads(self, batch: dict) -> tuple[torch.Tensor, list[dict]]:
        """The first half of a step, nothing updated: (the loss over the
        global batch, each rank's synced gradients by parameter name)."""
        ranks = self.ranks if self.ranks is not None else \
            self.model.tp_ranks()
        holder: list = [None] * len(ranks)

        def forward(b):
            r = spmd.rank_index()
            loss = make_loss_fn(ranks[r], self.cfg)(b)
            if self.data_axes:
                loss = pmean(loss, self.data_axes)
            holder[r] = loss
            return loss.detach()

        loss = shard_map(forward, mesh=self.mesh,
                         in_specs=(self.batch_spec,), out_specs=P())(batch)
        params = [dict(m.named_parameters()) for m in ranks]
        flat = [p for d in params for p in d.values()]
        gs = iter(torch.autograd.grad(holder[0], flat))
        holder.clear()
        self._join()
        grads = [{k: next(gs) for k in d} for d in params]

        def sync():
            r = spmd.rank_index()
            grads[r] = sync_grads_tp(
                grads[r], self.specs, self.data_axes, mode=self.par.grad_sync,
                mean=False, channels=self.par.ring_buckets,
                bidirectional=self.par.ring_bidirectional)

        # the backward's gradients are freed only after the ranks' streams
        # have joined the caller's.  A gradient of a leaf that several
        # ranks use (a router or an FSDP block) is allocated on the stream
        # its sum ran on, another rank's, and read here on this rank's;
        # freed inside this rank, the caching allocator would hand its
        # block to the next allocation on that stream while this rank's
        # reads are still queued (no repeat isolated this: the fault seen
        # was the shared gradient that spmd._Copy removed)
        raw = list(grads)
        with torch.no_grad():
            shard_map(sync, mesh=self.mesh, in_specs=(), out_specs=P())()
        del raw
        return loss, grads

    def __call__(self, opt: OptState, batch: dict) -> tuple[OptState, dict]:
        if self.opts is None or opt is not self._opt or \
                self.model.tp_ranks() is not self.ranks:
            self._scatter(opt)
        loss, grads = self.grads(batch)

        def update():
            r = spmd.rank_index()
            self.opts[r], metrics = adamw_update(
                dict(self.ranks[r].named_parameters()), grads[r],
                self.opts[r], self.tcfg, self.axes_of)
            return metrics

        metrics = shard_map(update, mesh=self.mesh, in_specs=(),
                            out_specs={"lr": P(), "grad_norm": P()})()
        metrics["loss"] = loss
        del grads
        self.model.gather(self.ranks)
        with torch.no_grad():
            for tree, key in ((opt.m, "m"), (opt.v, "v"),
                              (opt.master, "master")):
                if tree is None:
                    continue
                for k, t in tree.items():
                    t.copy_(gather_shards([getattr(o, key)[k]
                                           for o in self.opts],
                                          self.specs[k], self.mesh, t.device))
        self._opt = opt._replace(step=self.opts[0].step.to(opt.step.device,
                                                             copy=True))
        return self._opt, metrics


@dataclass
class StragglerMonitor:
    """EMA + z-score step-time anomaly detector (host side)."""
    alpha: float = 0.1
    z_thresh: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n > 5:
            sd = max(np.sqrt(self.var), 1e-6)
            if (dt - self.mean) / sd > self.z_thresh:
                self.events.append((step, dt, self.mean))
                self._update(dt)
                return True
        self._update(dt)
        return False

    def _update(self, dt: float):
        if self.n == 0:
            self.mean = dt
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1


@dataclass
class TrainerReport:
    steps_run: int
    final_loss: float
    losses: list
    restarts: int
    straggler_events: int


class Trainer:
    """End-to-end training driver with checkpoint/restart resilience, on
    the device of the model's parameters.  Under a ``mesh`` with ring or
    hierarchical ``grad_sync`` the step is a :class:`RingStep`: the trainer
    draws, checkpoints and restores rank 0's state (the model's), and the
    step copies it onto every replica whenever it was drawn or restored."""

    def __init__(self, model, cfg: ModelConfig, tcfg: TrainConfig,
                 par: ParallelConfig, mesh=None,
                 failure_injector=None):
        self.model = model
        self.cfg = cfg
        self.tcfg = tcfg
        self.par = par
        self.mesh = mesh
        self.device = _device(model)
        self.params = dict(model.named_parameters())
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep,
                                      async_write=tcfg.ckpt_async)
        self.monitor = StragglerMonitor()
        self.failure_injector = failure_injector
        self.step_fn = make_train_step(model, cfg, tcfg, par, mesh)
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))

    def _init_state(self) -> OptState:
        """Draw the parameters anew from ``tcfg.seed`` and return a fresh
        optimizer state."""
        self.model.init(torch.Generator(device=self.device).manual_seed(
            self.tcfg.seed))
        return init_opt_state(self.params, self.tcfg)

    def _restore(self, step: int, opt: OptState) -> tuple[OptState, int]:
        """Load checkpoint ``step`` into the parameters and ``opt``; returns
        (the optimizer state, the step to run next)."""
        (params, opt), extra = self.ckpt.restore(step, (self.params, opt))
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(params[name])
        return opt, extra["step"] + 1

    def run(self, steps: int | None = None) -> TrainerReport:
        steps = steps or self.tcfg.total_steps
        opt = self._init_state()
        start = 0
        latest = self.ckpt.latest_step()
        restarts = 0
        if latest is not None:
            opt, start = self._restore(latest, opt)
        losses = []
        s = start
        while s < steps:
            try:
                if self.failure_injector is not None:
                    self.failure_injector(s)
                toks, labs = self.data.batch(s)
                t0 = time.time()
                opt, metrics = self.step_fn(opt, {
                    "tokens": torch.from_numpy(toks).to(self.device),
                    "labels": torch.from_numpy(labs).to(self.device)})
                loss = float(metrics["loss"])
                self.monitor.observe(s, time.time() - t0)
                losses.append(loss)
                if (s + 1) % self.tcfg.ckpt_every == 0 or s == steps - 1:
                    self.ckpt.save(s, (self.params, opt), {"step": s})
                s += 1
            except SimulatedFailure:
                restarts += 1
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                opt = self._init_state()
                if latest is not None:
                    opt, s = self._restore(latest, opt)
                else:
                    s = 0
        self.ckpt.wait()
        return TrainerReport(steps_run=steps - start,
                             final_loss=losses[-1] if losses else float("nan"),
                             losses=losses, restarts=restarts,
                             straggler_events=len(self.monitor.events))


class SimulatedFailure(Exception):
    """Raised by failure injectors to emulate a node crash."""
