"""Carry parameter trees between the reference and the port's model.

The reference (``repro.models.lm.LM``) keeps each period position's
parameters under ``block_<i>`` with a leading ``[n_groups]`` axis, so
layer ``l`` is ``block_<l % period>[l // period]`` (``block_0[l]`` at
period 1; mixer leaves under ``attn`` or ``ssm``, FFN leaves under ``mlp``
or ``moe``).  Each leaf takes its ``ParamSpec``'s dtype: bf16, or float32
for the norms, the MoE router and the SSM's ``dt_bias``, ``A_log``, ``D``
and ``norm``, as the reference declares them.  The port keeps one :class:`~repro_torch.models.lm.Block`
per layer.  :func:`params_from_reference` carries the reference's tree in;
:func:`params_to_reference` gives the port's parameters back in the
reference's layout (to compare models trained on both sides).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, ParallelConfig
from ..device import resolve_device
from .lm import LM
from .model import check_ported
from .params import param_at, tree_leaves_with_path

__all__ = ["params_from_reference", "params_to_reference"]


def _reference_leaf(tree: dict, path: tuple, period: int) -> np.ndarray:
    """The reference's leaf for the port's ``path``."""
    if path[0] == "blocks":     # ("blocks", l, ...) -> block_<l % p>[l // p]
        g, i = divmod(int(path[1]), period)
        node = tree[f"block_{i}"]
        for k in path[2:]:
            node = node[k]
        return node[g]
    node = tree
    for k in path:
        node = node[k]
    return node


@torch.no_grad()
def params_from_reference(cfg: ModelConfig, tree: dict, device=None, *,
                          use_flash: bool = False,
                          use_ssd_kernel: bool = False,
                          par: ParallelConfig | None = None) -> LM:
    """The port's model of ``cfg`` holding the reference's parameters.

    ``tree`` is the reference's parameter tree as nested dicts of float32
    numpy arrays (``np.asarray(x, np.float32)`` of each leaf, which is exact
    for bf16 leaves); each is cast to its ``ParamSpec``'s dtype on
    ``device`` (``None`` is the CUDA card).
    """
    dev = resolve_device(device)
    check_ported(cfg)
    model = LM(cfg, par, use_flash=use_flash, use_ssd_kernel=use_ssd_kernel,
               device=dev)
    for path, spec in tree_leaves_with_path(model.param_spec()):
        src = np.array(_reference_leaf(tree, path, model.period),
                       np.float32)
        if src.shape != spec.shape:
            raise ValueError(f"{'/'.join(path)}: reference shape "
                             f"{src.shape}, port shape {spec.shape}")
        param_at(model, path).copy_(torch.from_numpy(src).to(spec.dtype))
    return model


@torch.no_grad()
def params_to_reference(model: LM) -> dict:
    """The model's parameters as the reference's tree (nested dicts; layer
    ``l`` of each block leaf stacked at ``block_<l % period>[...][l //
    period]``) of float32 numpy arrays: the inverse of
    :func:`params_from_reference`."""
    out: dict = {}
    stacked: dict = {}
    for path, _ in tree_leaves_with_path(model.param_spec()):
        x = param_at(model, path).detach().float().cpu().numpy()
        if path[0] == "blocks":
            g, i = divmod(int(path[1]), model.period)
            stacked.setdefault((f"block_{i}",) + path[2:], {})[g] = x
            continue
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    for sub, groups in stacked.items():
        node = out
        for k in sub[:-1]:
            node = node.setdefault(k, {})
        node[sub[-1]] = np.stack([groups[g] for g in range(len(groups))])
    return out
