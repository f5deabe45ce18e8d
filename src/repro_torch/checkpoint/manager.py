"""Checkpointing: async, atomic, keep-k, CRC-verified.

The port of ``repro/checkpoint/manager.py``, with the same on-disk layout:

    <dir>/step_<n>/
        manifest.json   {step, extra, leaves: {name: shape, dtype, crc}}
        <leaf-path>.npy one file per tree leaf (host numpy)

Writes go to step_<n>.tmp then rename (atomic on POSIX).  bf16 leaves are
stored as their ``uint16`` bits (numpy has no bf16), as the reference does.
Trees are nested dicts, lists, tuples and NamedTuples of tensors or numpy
arrays (``None`` leaves are skipped).  ``restore`` fills a tree shaped like
the one it is given, in each leaf's dtype: on the leaf's device, or, for a
leaf given a sharding (the reference's elastic restore onto a mesh), on
that sharding's mesh's first device, where the port's single controller
keeps global values (``shard_map``'s replicated outputs are rank 0's);
on a tensor-parallel mesh (a ``model`` axis larger than 1) as a
:class:`~repro_torch.parallel.sharding.RankShards`, each rank's block on
its device.  Saves hold global arrays (a partitioned model's blocks are
gathered into its own parameters after every step), so a restore onto a
mesh of another (data, model) shape cuts them anew.
The like tree may be abstract (``ShapeDtypeStruct``s, meta tensors).
"""
from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from ..models.params import ShapeDtypeStruct
from ..parallel.sharding import RankShards, shard_tensor

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif hasattr(tree, "_fields"):          # NamedTuple
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), prefix + (k,))
    elif tree is None:
        return
    else:
        yield prefix, tree


def _to_host(x) -> np.ndarray:
    """A numpy snapshot of a leaf; bf16 tensors as their uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16)
        return x.cpu().numpy()
    return np.array(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _from_host(arr: np.ndarray, dtype: str, like):
    """The stored array as a leaf like ``like``: a tensor on ``like``'s
    device in its dtype, or a numpy array in its dtype."""
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    want = np.dtype(str(like.dtype).removeprefix("torch."))
    return t.float().numpy().astype(want) if dtype == "bfloat16" \
        else arr.astype(want)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None):
        """Snapshot to host memory synchronously, write in background."""
        leaves = [(path, _to_host(x), _dtype_name(x))
                  for path, x in _flatten(tree)]
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, extra or {})

    def _write(self, step: int, leaves, extra: dict):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for path, arr, dtype in leaves:
            name = "__".join(path) or "root"
            np.save(tmp / f"{name}.npy", arr)
            manifest["leaves"][name] = {
                "shape": list(arr.shape), "dtype": dtype,
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, shardings=None, verify=True):
        """Restore into the structure of ``like_tree`` (tensors, numpy
        arrays, ``ShapeDtypeStruct``s, or anything with ``shape`` and
        ``dtype``), each leaf in its like's dtype.  ``shardings``: a
        matching tree of ``NamedSharding``s (elastic restore onto a mesh):
        a leaf with one comes back as a tensor on its mesh's first device,
        or, on a mesh whose ``model`` axis is larger than 1, as a
        ``RankShards`` of every rank's block on its device; a leaf
        without one on its like's device, which raises
        ``ValueError`` for a meta tensor or a struct.  Returns (tree, the
        ``extra`` dict saved with it)."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        sh_flat = dict(_flatten(shardings)) if shardings is not None else {}
        out = {}
        for path, like in _flatten(like_tree):
            name = "__".join(path) or "root"
            arr = np.load(d / f"{name}.npy")
            meta = manifest["leaves"][name]
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc"]:
                    raise IOError(f"checkpoint corruption in {name}")
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch {name}: "
                                 f"{arr.shape} vs {tuple(like.shape)}")
            sh = sh_flat.get(path)
            if sh is not None and sh.mesh.shape.get("model", 1) > 1:
                full = _from_host(arr, meta["dtype"], torch.empty(
                    (), dtype=_torch_dtype(like.dtype)))
                out[path] = RankShards(sh, shard_tensor(full, sh.spec,
                                                        sh.mesh))
            elif sh is not None:
                out[path] = _from_host(arr, meta["dtype"], torch.empty(
                    (), dtype=_torch_dtype(like.dtype),
                    device=sh.mesh.devices.flat[0]))
            elif isinstance(like, ShapeDtypeStruct) or \
                    getattr(like, "is_meta", False):
                raise ValueError(f"{name}: an abstract like (a meta tensor "
                                 "or a struct) needs a sharding to say "
                                 "where it goes")
            else:
                out[path] = _from_host(arr, meta["dtype"], like)
        return _unflatten_like(like_tree, out), manifest["extra"]


def _unflatten_like(like, flat: dict, prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(**{k: _unflatten_like(getattr(like, k), flat,
                                                prefix + (k,))
                             for k in like._fields})
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, prefix + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return flat[prefix]
