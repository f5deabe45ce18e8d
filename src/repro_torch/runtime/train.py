"""Training runtime: the step (value and gradient of the loss, then AdamW),
checkpoint/restart fault tolerance, straggler monitor.

The port of ``repro/runtime/train.py``.  Fault model:
  * node failure -> the job restarts from the latest checkpoint; since data
    order is a pure function of (seed, step), training replays the same
    batches after a restart.
  * stragglers -> per-step wall-time EMA + z-score detector.
The model owns its parameters, so a step updates them in place and returns
the optimizer state and metrics.  Everything runs where the model's
parameters lie.  The explicit ring and hierarchical gradient syncs under a
mesh wait for the collectives step of ROADMAP queue 1.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..config import ModelConfig, ParallelConfig, TrainConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..launch.steps import cross_entropy
from ..optim.adamw import OptState, adamw_update, init_opt_state

__all__ = ["make_loss_fn", "make_train_step", "StragglerMonitor",
           "TrainerReport", "Trainer", "SimulatedFailure"]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_loss_fn(model, cfg: ModelConfig):
    """batch {"tokens", "labels"} ([B, S] integer tensors) -> the mean
    next-token cross entropy over the real vocabulary, plus the model's
    auxiliary loss."""
    def loss_fn(batch):
        logits, aux = model.apply(batch["tokens"])
        return cross_entropy(logits[..., :cfg.vocab_size],
                             batch["labels"]) + aux
    return loss_fn


def make_train_step(model, cfg: ModelConfig, tcfg: TrainConfig,
                    par: ParallelConfig, mesh=None):
    """Returns ``step(opt, batch) -> (opt, metrics)``: the value and
    gradient of the loss over the model's parameters, then
    :func:`~repro_torch.optim.adamw.adamw_update` on them in place.
    ``metrics`` holds 0-d tensors "loss", "lr" and "grad_norm" on the
    model's device.  ``grad_sync`` "xla" (or no mesh) is the only mode: one
    card needs no gradient sync."""
    if mesh is not None and par.grad_sync != "xla":
        raise NotImplementedError(
            f"grad_sync={par.grad_sync!r} under a mesh: the ring and "
            "hierarchical collectives come with the collectives step of "
            "ROADMAP queue 1")
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
    the device of the model's parameters."""

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
