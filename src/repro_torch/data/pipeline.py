"""Deterministic, sharded, resumable synthetic LM data pipeline.

The port of ``repro/data/pipeline.py``, a plain numpy copy: batches equal
the reference's bit for bit.

Tokens are drawn from a Zipf-like distribution with a deterministic
per-(step, host_shard) PRNG, so any host can reproduce any step's batch
without coordination — checkpoint/restart and *elastic* restarts (different
data-parallel world size) resume exactly: the iterator state is just the
step counter.

A file-backed mode memory-maps a pre-generated token binary and serves
strided windows (exercises the real I/O path in examples/tests).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]

@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    path: str | None = None        # file-backed mode


class SyntheticLM:
    """next-token-prediction batches with a learnable structure: token t+1
    depends on t via a fixed random permutation + noise, so a real model can
    drive the loss well below the unigram entropy (used to validate
    end-to-end training)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._perm = rng.permutation(cfg.vocab_size)
        # zipf-ish unigram distribution over a capped support
        ranks = np.arange(1, cfg.vocab_size + 1)
        p = 1.0 / ranks ** cfg.zipf_a
        self._p = p / p.sum()
        self._mmap = None
        if cfg.path:
            self._mmap = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """Returns (tokens, labels) [B/n_shards, S] for this host shard."""
        cfg = self.cfg
        bsz = cfg.global_batch // n_shards
        if self._mmap is not None:
            S = cfg.seq_len
            n_tok = self._mmap.shape[0] - S - 1
            starts = (np.arange(bsz) * 9973 + step * 31337 +
                      shard * 7919) % n_tok
            tokens = np.stack([self._mmap[s: s + S] for s in starts])
            labels = np.stack([self._mmap[s + 1: s + S + 1] for s in starts])
            return tokens.astype(np.int32), labels.astype(np.int32)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        first = rng.choice(cfg.vocab_size, size=(bsz, 1), p=self._p)
        noise = rng.random((bsz, cfg.seq_len)) < 0.15
        rnd = rng.choice(cfg.vocab_size, size=(bsz, cfg.seq_len), p=self._p)
        seq = np.empty((bsz, cfg.seq_len + 1), np.int32)
        seq[:, :1] = first
        for t in range(cfg.seq_len):
            det = self._perm[seq[:, t]]
            seq[:, t + 1] = np.where(noise[:, t], rnd[:, t], det)
        return seq[:, :-1].copy(), seq[:, 1:].copy()

    @staticmethod
    def write_corpus(path: str | Path, n_tokens: int, vocab: int,
                     seed: int = 0):
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1)
        p = (1.0 / ranks ** 1.2)
        p /= p.sum()
        toks = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
        toks.tofile(str(path))
        return path


class Prefetcher:
    """Background-thread prefetch of the next batch (overlaps host data
    generation with the device step)."""

    def __init__(self, source: SyntheticLM, start_step: int, shard: int = 0,
                 n_shards: int = 1, depth: int = 2):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = False
        self.step = start_step

        def worker():
            s = start_step
            while not self._stop:
                self._q.put((s, source.batch(s, shard, n_shards)))
                s += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        step, batch = self._q.get()
        self.step = step
        return step, batch

    def close(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
