"""Carry parameter trees between the reference and the port's model.

The reference's ``LM`` keeps each period position's parameters under
``block_<i>`` with a leading ``[n_groups]`` axis, so layer ``l`` is
``block_<l % period>[l // period]`` (``block_0[l]`` at period 1; mixer
leaves under ``attn`` (GQA or MLA) or ``ssm``, FFN leaves under ``mlp`` or
``moe``).  Its ``EncDec`` stacks ``encoder`` ``[E, ...]`` and ``decoder``
``[L, ...]``, so encoder layer ``l`` is ``encoder[...][l]``.  Each leaf
takes its ``ParamSpec``'s dtype: bf16, or float32 for the norms (MLA's
latent norms too), the MoE router and the SSM's ``dt_bias``, ``A_log``,
``D`` and ``norm``, as the reference declares them.  The port keeps one
:class:`~repro_torch.models.lm.Block` per layer.
:func:`params_from_reference` carries the reference's tree in;
:func:`params_to_reference` gives the port's parameters back in the
reference's layout (to compare models trained on both sides);
:func:`ranks_from_reference` carries it onto the ranks of a
tensor-parallel mesh, each rank's blocks on its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, ParallelConfig
from ..device import resolve_device
from .encdec import EncDec
from .lm import LM
from .model import make_model
from .params import param_at, tree_leaves_with_path

__all__ = ["params_from_reference", "params_to_reference",
           "ranks_from_reference"]


def _stacked(model, path: tuple) -> tuple[tuple, int] | None:
    """Where the reference stacks the port's per-layer leaf ``path``: (its
    path without the layer, the index on the leading axis), or None for a
    leaf the reference keeps as it is.  ``("blocks", l, ...)`` ->
    ``block_<l % period>[...][l // period]``; ``("encoder" | "decoder",
    l, ...)`` -> ``encoder | decoder[...][l]``."""
    if path[0] == "blocks":
        g, i = divmod(int(path[1]), model.period)
        return (f"block_{i}",) + path[2:], g
    if path[0] in ("encoder", "decoder"):
        return (path[0],) + path[2:], int(path[1])
    return None


def _reference_leaf(tree: dict, path: tuple, model) -> np.ndarray:
    """The reference's leaf for the port's ``path``."""
    at = _stacked(model, path)
    node = tree
    for k in (path if at is None else at[0]):
        node = node[k]
    return node if at is None else node[at[1]]


@torch.no_grad()
def params_from_reference(cfg: ModelConfig, tree: dict, device=None, *,
                          use_flash: bool = False,
                          use_ssd_kernel: bool = False,
                          par: ParallelConfig | None = None, mesh=None,
                          rules=None) -> LM | EncDec:
    """The port's model of ``cfg`` holding the reference's parameters.

    ``tree`` is the reference's parameter tree as nested dicts of float32
    numpy arrays (``np.asarray(x, np.float32)`` of each leaf, which is exact
    for bf16 leaves); each is cast to its ``ParamSpec``'s dtype on
    ``device`` (``None`` is the CUDA card).  Under a ``mesh`` with a
    ``model`` axis the trees are padded (heads, vocabulary) as the
    reference's model built on that mesh pads them.
    """
    dev = resolve_device(device)
    model = make_model(cfg, par, use_flash, use_ssd_kernel, dev, mesh, rules)
    for path, spec in tree_leaves_with_path(model.param_spec()):
        src = np.array(_reference_leaf(tree, path, model), np.float32)
        if src.shape != spec.shape:
            raise ValueError(f"{'/'.join(path)}: reference shape "
                             f"{src.shape}, port shape {spec.shape}")
        param_at(model, path).copy_(torch.from_numpy(src).to(spec.dtype))
    return model


def ranks_from_reference(cfg: ModelConfig, tree: dict, mesh, **kw
                         ) -> tuple[LM, list[LM]]:
    """(the port's model of ``cfg`` on ``mesh``'s first device holding the
    reference's parameters, padded for the mesh's ``model`` axis; its rank
    modules, each holding its blocks by the model's shardings on its
    device): :func:`params_from_reference` then ``LM.tp_ranks``."""
    model = params_from_reference(cfg, tree, mesh.devices.flat[0], mesh=mesh,
                                  **kw)
    return model, model.tp_ranks()


@torch.no_grad()
def params_to_reference(model: LM | EncDec) -> dict:
    """The model's parameters as the reference's tree (nested dicts; layer
    ``l`` of each block leaf stacked at ``block_<l % period>[...][l //
    period]``, of each encoder or decoder leaf at ``encoder | decoder[...]
    [l]``) of float32 numpy arrays: the inverse of
    :func:`params_from_reference`."""
    out: dict = {}
    stacked: dict = {}
    for path, _ in tree_leaves_with_path(model.param_spec()):
        x = param_at(model, path).detach().float().cpu().numpy()
        at = _stacked(model, path)
        if at is not None:
            stacked.setdefault(at[0], {})[at[1]] = x
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
