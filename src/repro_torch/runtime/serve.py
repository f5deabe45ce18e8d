"""Batched serving engine: continuous batching over a request queue.

The port of ``repro/runtime/serve.py``.  Prompts are prefilled token by
token through ``model.decode_step`` (as the reference does); decode steps
run the whole active batch.  Slots free as requests hit max_tokens and are
refilled from the queue — the standard continuous-batching loop.  Decode
runs under ``torch.inference_mode()`` and writes the caches in place
(where the reference donates them to a jitted step).

As in the reference, admitting a request resets only its slot's position,
and every prompt token runs the whole batch with token 0 in the other
slots.  A KV cache is unharmed by that (the stray write lands at the other
slot's unchanged position and is overwritten by its next real step); an
SSM cache is not: a reused slot starts from the previous request's state
and conv window, and each prompt token of a new request steps every other
active slot's state once on token 0.  The port reproduces this.

Unlike the reference, which drops a KV-cache write past the cache's end
and attends over stale entries, the engine raises ``ValueError`` on the
host before a decode step would write such a position.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..config import ServeConfig
from ..device import resolve_device

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    _next: int = 0                # the token the next decode step feeds


class ServeEngine:
    """Serve ``model`` (an :class:`~repro_torch.models.lm.LM` on ``device``;
    ``None`` is the CUDA card and raises without one)."""

    def __init__(self, model, scfg: ServeConfig, device=None):
        self.device = resolve_device(device)
        pdev = model.final_norm["scale"].device
        if pdev.type != self.device.type or \
                self.device.index not in (None, pdev.index):
            raise ValueError(f"ServeEngine: the model is on {pdev}, not on "
                             f"{self.device}")
        self.model = model
        self.scfg = scfg
        B, S = scfg.batch, scfg.max_seq
        self.cache = model.init_cache(B, S)
        cfg = model.cfg
        # positions a KV cache holds (None: the model has no attention)
        self.kv_len = model.kv_cache_len(S) if any(
            model.layer_kind(i) == "attn" for i in range(cfg.num_layers)) \
            else None
        self.pos = np.zeros(B, np.int32)
        self.active: list[Request | None] = [None] * B
        self.queue: deque[Request] = deque()

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One decode step of every slot; returns logits [B, 1, vocab]."""
        if self.kv_len is not None:
            w = self.model.cfg.sliding_window
            out = (self.pos % w if w else self.pos) >= self.kv_len
            if out.any():
                raise ValueError(
                    f"ServeEngine: position {int(self.pos[out][0])} falls "
                    f"outside the KV cache of {self.kv_len} positions "
                    f"(max_seq {self.scfg.max_seq}, window {w or 'none'})")
        dev = self.device
        logits, self.cache = self.model.decode_step(
            self.cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(self.pos).to(dev))
        return logits

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.scfg.batch):
            if self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                self.active[slot] = req
                # prefill token-by-token through the decode path
                self.pos[slot] = 0
                self._prefill_slot(slot, req)

    def _prefill_slot(self, slot: int, req: Request):
        for t in req.prompt:
            tokens = np.zeros((self.scfg.batch, 1), np.int32)
            tokens[slot, 0] = t
            logits = self._decode(tokens)
            self.pos[slot] += 1
        req._next = int(torch.argmax(logits[slot, -1]))

    def step(self) -> int:
        """One decode step for the whole active batch. Returns #finished."""
        self._admit()
        tokens = np.zeros((self.scfg.batch, 1), np.int32)
        for slot, req in enumerate(self.active):
            if req is not None:
                tokens[slot, 0] = req._next
        logits = self._decode(tokens)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        finished = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(tokens[slot, 0]))
            req._next = int(nxt[slot])
            self.pos[slot] += 1
            if len(req.out) >= req.max_new_tokens or \
                    self.pos[slot] >= self.scfg.max_seq - 1:
                req.done = True
                self.active[slot] = None
                finished += 1
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        all_reqs = list(self.queue)
        for _ in range(max_steps):
            self.step()
            if not self.queue and all(a is None for a in self.active):
                break
        return [r for r in all_reqs if r.done]
