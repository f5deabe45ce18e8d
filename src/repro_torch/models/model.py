"""Model factory: ModelConfig -> LM, on the caller's device."""
from __future__ import annotations

import torch

from ..config import ModelConfig, ParallelConfig
from ..device import resolve_device
from .lm import LM

__all__ = ["build_model", "check_ported", "NOT_PORTED"]

# what this slice of the port does not build yet, and the ROADMAP item
# (queue 1 item 1, "left" list) that ports it
NOT_PORTED = {
    "encdec": "encdec.py: ROADMAP queue 1 item 1, left 3",
    "vlm": "M-RoPE: ROADMAP queue 1 item 1, left 3",
    "mla": "mla.py: ROADMAP queue 1 item 1, left 3",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless this slice builds ``cfg``."""
    for key in (cfg.family, cfg.attention):
        if key in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {key} is not ported yet ({NOT_PORTED[key]})")
    gqa = cfg.family in ("dense", "moe", "hybrid") and \
        (cfg.attention, cfg.pos_emb) == ("gqa", "rope")
    ssm = (cfg.family, cfg.attention, cfg.pos_emb) == ("ssm", "none", "none")
    if not (gqa or ssm):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, attention "
            f"{cfg.attention!r}, positions {cfg.pos_emb!r} are not ported")


def build_model(cfg: ModelConfig, par: ParallelConfig | None = None,
                use_flash: bool = False, use_ssd_kernel: bool = False,
                device=None, seed: int = 0) -> LM:
    """The model of ``cfg`` with its parameters drawn on ``device`` (``None``
    is the CUDA card; raises without one) from a generator seeded with
    ``seed``, by the reference's initializers.  ``par.remat`` other than
    ``"none"`` recomputes each block in the backward; ``use_flash`` routes
    the full-sequence attention (prefill and training) through the flash
    kernels, ``use_ssd_kernel`` the SSM mixer's prefill scan through the
    SSD kernel (forward only: training raises there)."""
    check_ported(cfg)
    dev = resolve_device(device)
    model = LM(cfg, par, use_flash=use_flash, use_ssd_kernel=use_ssd_kernel,
               device=dev)
    return model.init(torch.Generator(device=dev).manual_seed(seed))
