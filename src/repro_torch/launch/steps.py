"""Per-architecture training policy and the training loss.

The port of part of ``repro/launch/steps.py``: ``ARCH_POLICY``,
:func:`make_parallel_config`, :func:`make_train_config` (``:29-64``) and
:func:`cross_entropy` (``:197-219``).  The meshes are ``launch/mesh.py``.
``Cell``, ``build_cell`` and the dry-run cells come with the launch step,
ROADMAP queue 1 item 1, left 5: their XLA lower-and-compile memory and
cost analyses need a counterpart of their own.
"""
from __future__ import annotations

from typing import Any

import torch

from ..config import ParallelConfig, ShapeSpec, TrainConfig
from ..configs import registry

__all__ = ["ARCH_POLICY", "make_parallel_config", "make_train_config",
           "cross_entropy"]

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
    mean over the whole [B, S] at once, as the reference does."""
    B, S, _ = logits.shape
    if S % chunk or S <= chunk:
        return _token_nll(logits, labels).mean()
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(0, S, chunk):
        total = total + _token_nll(logits[:, i:i + chunk],
                                   labels[:, i:i + chunk]).sum()
    return total / torch.tensor(B * S, dtype=torch.float32,
                                device=logits.device)
