"""Model factory: ModelConfig -> LM or EncDec, on the caller's device,
with the reference's mesh-aware sharding rules.

Under a mesh whose ``model`` axis is larger than 1, :func:`build_model`
builds the dense GQA and MLA, MoE, SSM and hybrid families
(:func:`~.lm.tp_ported`), which run tensor-parallel (``models/lm.py``),
and raises ``NotImplementedError`` for every other family (VLM,
encoder-decoder: :func:`check_tp`); :func:`make_model` builds any
family on any mesh (the dry-run sizes every cell from it)."""
from __future__ import annotations

import torch

from ..config import ModelConfig, ParallelConfig
from ..device import resolve_device
from ..parallel.sharding import make_rules
from .encdec import EncDec
from .lm import LM, TP_LEFT, tp_ported

__all__ = ["build_model", "check_ported", "check_tp", "make_model",
           "replicate", "NOT_PORTED"]

# what this port does not build yet, and the ROADMAP item (queue 1 item 1,
# "left" list) that ports it: every family of the shipped configs is ported
NOT_PORTED: dict[str, str] = {}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port builds ``cfg``: the
    combinations of family, attention and positions that the shipped
    configs use."""
    for key in (cfg.family, cfg.attention):
        if key in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {key} is not ported yet ({NOT_PORTED[key]})")
    kind = (cfg.family, cfg.attention, cfg.pos_emb)
    if kind == ("dense", "mla", "rope") and cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: MLA with a sliding window is not ported (the "
            "reference's latent cache has no window)")
    gqa = cfg.family in ("dense", "moe", "hybrid") and \
        kind[1:] == ("gqa", "rope")
    if not (gqa or kind in (("dense", "mla", "rope"), ("ssm", "none", "none"),
                            ("vlm", "gqa", "mrope"),
                            ("encdec", "gqa", "learned"))):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, attention "
            f"{cfg.attention!r}, positions {cfg.pos_emb!r} are not ported")


def check_tp(cfg: ModelConfig, mesh, model=None) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` has a ``model`` axis
    larger than 1 and tensor parallelism is not ported for ``cfg``'s
    family (the VLM and the encoder-decoder), or ``model``'s
    parameters do not split evenly over it."""
    tp = 1 if mesh is None else mesh.shape.get("model", 1)
    if tp > 1 and not tp_ported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over a model axis of {tp} is "
            f"ported for the dense GQA and MLA, MoE, SSM and hybrid "
            f"families only, "
            f"not for family "
            f"{cfg.family!r} (attention {cfg.attention!r}, positions "
            f"{cfg.pos_emb!r}): {TP_LEFT}")
    if tp > 1 and model is not None and (
            model.mesh is None or dict(model.mesh.shape) != dict(mesh.shape)):
        raise ValueError(f"{cfg.name}: a tensor-parallel step needs the "
                         f"model built on its mesh ({dict(mesh.shape)})")
    if tp > 1 and model is not None and not model.partitioned:
        raise NotImplementedError(
            f"{cfg.name}: a parameter does not split evenly over the mesh "
            f"{dict(mesh.shape)} (d_ff {cfg.d_ff}, d_model {cfg.d_model}): "
            f"uneven tensor parallelism is not ported ({TP_LEFT})")


def make_model(cfg: ModelConfig, par: ParallelConfig | None = None,
               use_flash: bool = False, use_ssd_kernel: bool = False,
               device=None, mesh=None, rules=None,
               tp: int | None = None) -> LM | EncDec:
    """The unfilled model of ``cfg`` on ``device`` (a ``torch.device``):
    :class:`EncDec` for the ``encdec`` family, :class:`LM` otherwise.
    Under a ``mesh`` without ``rules`` the rules are the reference's
    ``make_rules(fsdp=par.fsdp, seq_shard_decode=par.seq_shard_decode)``.
    ``tp`` pads an LM's heads and vocabulary as a ``model`` axis of that
    size would (default: the mesh's)."""
    check_ported(cfg)
    if rules is None and mesh is not None:
        p = par or ParallelConfig()
        rules = make_rules(fsdp=p.fsdp, seq_shard_decode=p.seq_shard_decode)
    if cfg.family == "encdec":
        return EncDec(cfg, par, use_flash=use_flash, device=device,
                      mesh=mesh, rules=rules)
    return LM(cfg, par, use_flash=use_flash, use_ssd_kernel=use_ssd_kernel,
              device=device, mesh=mesh, rules=rules, tp=tp)


def replicate(model: LM | EncDec, device, one_device: bool = False
              ) -> LM | EncDec:
    """A copy of ``model`` (its configuration, mesh and parameters, in
    their dtypes) on ``device``; with ``one_device``, without the mesh:
    the one-device model of the same (padded) parameter tree."""
    dev = torch.device(device)
    if one_device:
        rep = make_model(model.cfg, model.par, model.use_flash,
                         getattr(model, "use_ssd_kernel", False), dev,
                         tp=model.tp)
    else:
        rep = make_model(model.cfg, model.par, model.use_flash,
                         getattr(model, "use_ssd_kernel", False), dev,
                         model.mesh, model.rules)
    for p, q in zip(rep.parameters(), model.parameters()):
        p.data = q.detach().to(dev, copy=True)
    return rep


def build_model(cfg: ModelConfig, par: ParallelConfig | None = None,
                use_flash: bool = False, use_ssd_kernel: bool = False,
                device=None, seed: int = 0, mesh=None,
                rules=None) -> LM | EncDec:
    """The model of ``cfg`` with its parameters drawn on ``device`` (``None``
    is the mesh's first device, else the CUDA card; raises without one)
    from a generator seeded with ``seed``, by the reference's initializers.
    ``mesh``/``rules`` as in :func:`make_model`.  ``par.remat`` other than
    ``"none"`` recomputes each block in the backward; ``use_flash`` routes
    the full-sequence causal self-attention (prefill and training) through
    the flash kernels, ``use_ssd_kernel`` the SSM mixer's prefill scan
    through the SSD kernel (forward only: training raises there).  Under a
    ``model`` axis larger than 1 it raises for a family without tensor
    parallelism (:func:`check_tp`)."""
    check_tp(cfg, mesh)
    if device is None and mesh is not None:
        device = mesh.devices.flat[0]
    dev = resolve_device(device)
    model = make_model(cfg, par, use_flash, use_ssd_kernel, dev, mesh, rules)
    return model.init(torch.Generator(device=dev).manual_seed(seed))
